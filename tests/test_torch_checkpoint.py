"""The port's checkpoints held to the JAX package's ``repro.checkpoint``.

A tree saved by the port and the same tree (as numpy) saved by the JAX
package give the same ``manifest.json`` (step, extras, every array's key,
file, shape and logical dtype) and the same ``.npy`` bytes' values, bfloat16
included (stored as its uint16 bits); each package restores the other's
checkpoint bit for bit.  Then the round trip of an LM and its optimizer
state, in place; an LM's optimizer state under the JAX package's names,
read by each package from the other's checkpoint; and the mirrors of
``tests/test_substrate.py::TestCheckpoint``: ``latest_step``,
``cleanup_old``, a ``strict=False`` restore, a strict one that raises, and
the atomic rename (a ``.tmp`` directory is never a step).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cuda import cuda, jax_on_cpu  # noqa: F401  (fixtures)
from repro.checkpoint.checkpoint import restore_checkpoint as jax_restore
from repro.checkpoint.checkpoint import save_checkpoint as jax_save
from repro.configs import get_config as jax_config
from repro.models import build_model as jax_build
from repro.models.params import initialize as jax_initialize
from repro.optim.optimizer import make_optimizer as jax_optimizer
from repro_torch.checkpoint.checkpoint import (cleanup_old, latest_step, restore_checkpoint,
                                               save_checkpoint)
from repro_torch.configs import get_config
from repro_torch.convert import group
from repro_torch.models import build_model
from repro_torch.optim.optimizer import make_optimizer

pytestmark = pytest.mark.usefixtures("jax_on_cpu")

torch.set_num_threads(1)


def _numpy_tree():
    rng = np.random.default_rng(0)
    return {"w": rng.standard_normal((2, 3)).astype(np.float32),
            "nested": {"b": rng.standard_normal(4).astype(np.float32),
                       "ids": np.arange(5, dtype=np.int32)},
            "layers": [{"a": rng.standard_normal(3).astype(np.float32)} for _ in range(2)]}


def _bf16(tree):
    """The tree with nested/b in bfloat16: (the JAX package's, the port's)."""
    jtree = jax.tree.map(jnp.asarray, tree)
    jtree["nested"]["b"] = jtree["nested"]["b"].astype(jnp.bfloat16)
    ttree = jax.tree.map(torch.as_tensor, tree)
    ttree["nested"]["b"] = ttree["nested"]["b"].to(torch.bfloat16)
    return jtree, ttree


def _opt_tree():
    return {"w": {"_s_m": np.ones((2, 3), np.float32)},
            "nested": {"b": {"_s_m": np.full(4, 2.0, np.float32)}}}


def _bits(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _zeros_like(tree):
    return jax.tree.map(torch.zeros_like, tree)


def test_manifest_and_files_equal_the_jax_packages(tmp_path):
    jtree, ttree = _bf16(_numpy_tree())
    extras = {"pipeline": {"cursor": 112, "seed": 0}}
    jax_save(str(tmp_path / "jax"), 7, jtree, jax.tree.map(jnp.asarray, _opt_tree()), extras)
    save_checkpoint(str(tmp_path / "port"), 7, ttree,
                    jax.tree.map(torch.as_tensor, _opt_tree()), extras)
    dirs = [tmp_path / "jax" / "step_00000007", tmp_path / "port" / "step_00000007"]
    want, got = (json.loads((d / "manifest.json").read_text()) for d in dirs)
    assert got == want
    assert got["arrays"]["p§nested§b"]["dtype"] == "bfloat16"
    assert "o§w§_s_m" in got["arrays"] and "p§layers§1§a" in got["arrays"]
    for info in want["arrays"].values():
        a, b = (np.load(d / info["file"]) for d in dirs)
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert sorted(os.listdir(dirs[0])) == sorted(os.listdir(dirs[1]))


def test_roundtrip_is_bitwise(tmp_path):
    _, ttree = _bf16(_numpy_tree())
    otree = jax.tree.map(torch.as_tensor, _opt_tree())
    save_checkpoint(str(tmp_path), 7, ttree, otree,
                    extras={"pipeline": {"cursor": 112, "seed": 0}})
    assert latest_step(str(tmp_path)) == 7
    like, olike = _zeros_like(ttree), _zeros_like(otree)
    step, p2, o2, extras = restore_checkpoint(str(tmp_path), like, olike)
    assert step == 7 and extras["pipeline"]["cursor"] == 112
    assert p2 is like and o2 is olike                 # loaded in place
    assert like["nested"]["b"].dtype == torch.bfloat16
    for want, got in zip(jax.tree.leaves(ttree) + jax.tree.leaves(otree),
                         jax.tree.leaves(like) + jax.tree.leaves(olike)):
        assert want.dtype == got.dtype and np.array_equal(_bits(want), _bits(got))


def test_each_package_restores_the_others_checkpoint(tmp_path):
    jtree, ttree = _bf16(_numpy_tree())
    jax_save(str(tmp_path / "jax"), 3, jtree)
    like = _zeros_like(ttree)
    restore_checkpoint(str(tmp_path / "jax"), like)
    for want, got in zip(jax.tree.leaves(ttree), jax.tree.leaves(like)):
        assert np.array_equal(_bits(want), _bits(got))
    save_checkpoint(str(tmp_path / "port"), 3, ttree)
    _, back, _, _ = jax_restore(str(tmp_path / "port"), jtree)
    assert back["nested"]["b"].dtype == jnp.bfloat16
    for want, got in zip(jax.tree.leaves(jtree), jax.tree.leaves(back)):
        assert np.array_equal(np.asarray(want), np.asarray(got))


def _model_and_state(device, seed: int):
    cfg = get_config("xlstm-125m").reduced()
    model = build_model(cfg, device=device,
                        generator=torch.Generator(device=device).manual_seed(seed))
    opt = make_optimizer("adamw")
    groups = group(dict(model.named_parameters()), model)
    state = opt.init(groups)
    grads = {k: ([torch.randn_like(m) for m in g] if isinstance(g, list) else torch.randn_like(g))
             for k, g in groups.items()}
    opt.update(grads, state, groups, 0)
    return model, state


def _module_roundtrip(tmp_path, device):
    model, state = _model_and_state(device, 0)
    save_checkpoint(str(tmp_path), 4, model, state, extras={"pipeline": {"cursor": 8, "seed": 0}})
    manifest = json.loads((tmp_path / "step_00000004" / "manifest.json").read_text())
    assert "p§layers§1§slstm§r_gates" in manifest["arrays"]
    assert "o§slots§s1§slstm§r_gates§_s_v" in manifest["arrays"]
    fresh, fresh_state = _model_and_state(device, 1)
    step, _, _, extras = restore_checkpoint(str(tmp_path), fresh, fresh_state)
    assert step == 4 and extras["pipeline"]["cursor"] == 8
    for (name, want), got in zip(model.named_parameters(), fresh.parameters()):
        assert got.device == want.device and torch.equal(got, want), name
    for key, fields in state.items():
        for field, want in fields.items():
            assert torch.equal(fresh_state[key][field], want), (key, field)


def test_module_and_optimizer_state_roundtrip_in_place(tmp_path):
    _module_roundtrip(tmp_path, torch.device("cpu"))


@pytest.mark.cuda
def test_module_and_optimizer_state_roundtrip_on_the_card(tmp_path, cuda):  # noqa: F811
    _module_roundtrip(tmp_path, cuda)


def _leaf(state, key: str, field: str):
    """One field of one leaf of a nested (JAX) optimizer state, by the
    port's key ("slots/s1/mlstm/wq")."""
    node = state
    for part in key.split("/"):
        node = node[part]
    return np.asarray(node[field])


def test_optimizer_state_crosses_packages(tmp_path):
    """An LM's AdamW state saved by the port has the names, shapes and
    dtypes that ``repro.checkpoint`` writes for the JAX optimizer's state of
    the same model, and ``repro.checkpoint`` restores it bit for bit; the
    port restores the JAX package's state bit for bit in turn."""
    model, state = _model_and_state(torch.device("cpu"), 0)
    jparams = jax_initialize(jax_build(jax_config("xlstm-125m").reduced()).specs(),
                             jax.random.PRNGKey(0))
    jstate = jax_optimizer("adamw").init(jparams)
    save_checkpoint(str(tmp_path / "port"), 4, model, state)
    jax_save(str(tmp_path / "jax"), 4, jparams, jstate)
    got, want = ({name: (info["shape"], info["dtype"]) for name, info in json.loads(
        (tmp_path / d / "step_00000004" / "manifest.json").read_text())["arrays"].items()
        if name.startswith("o§")} for d in ("port", "jax"))
    assert got == want and "o§slots§s1§slstm§r_gates§_s_v" in got
    _, _, back, _ = jax_restore(str(tmp_path / "port"), {}, jstate)
    for key, fields in state.items():
        for field, t in fields.items():
            assert np.array_equal(_leaf(back, key, field), t.numpy()), (key, field)

    rng = np.random.default_rng(2)
    jstate = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32), jstate)
    jax_save(str(tmp_path / "jax"), 5, {}, jax.tree.map(jnp.asarray, jstate))
    fresh = make_optimizer("adamw").init(group(dict(model.named_parameters()), model))
    restore_checkpoint(str(tmp_path / "jax"), {}, fresh)
    for key, fields in fresh.items():
        for field, t in fields.items():
            assert np.array_equal(t.numpy(), _leaf(jstate, key, field)), (key, field)


def test_cleanup_keeps_latest(tmp_path):
    p = {"w": torch.zeros(2)}
    for s in (1, 2, 3, 4, 5):
        save_checkpoint(str(tmp_path), s, p)
    cleanup_old(str(tmp_path), keep=2)
    assert latest_step(str(tmp_path)) == 5
    assert len(os.listdir(tmp_path)) == 2


def test_nonstrict_partial_restore(tmp_path):
    save_checkpoint(str(tmp_path), 1, {"w": torch.ones(3)})
    like = {"w": torch.zeros(3), "new": torch.full((2,), 9.0)}
    step, p2, _, _ = restore_checkpoint(str(tmp_path), like, strict=False)
    np.testing.assert_array_equal(p2["w"].numpy(), np.ones(3))
    np.testing.assert_array_equal(p2["new"].numpy(), [9.0, 9.0])


def test_strict_missing_raises(tmp_path):
    save_checkpoint(str(tmp_path), 1, {"w": torch.ones(3)})
    with pytest.raises(KeyError, match="p§x"):
        restore_checkpoint(str(tmp_path), {"w": torch.zeros(3), "x": torch.zeros(1)})
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "none"), {"w": torch.zeros(3)})


def test_atomic_rename_and_tmp_ignored(tmp_path):
    """A step is written to ``.tmp`` and renamed: a ``.tmp`` left by a crash
    is never the latest step, and saving a step again replaces it whole."""
    save_checkpoint(str(tmp_path), 2, {"w": torch.ones(3)})
    os.makedirs(tmp_path / "step_00000009.tmp")
    assert latest_step(str(tmp_path)) == 2
    assert not (tmp_path / "step_00000002.tmp").exists()
    save_checkpoint(str(tmp_path), 2, {"w": torch.full((3,), 5.0)})
    like = {"w": torch.zeros(3)}
    restore_checkpoint(str(tmp_path), like)
    np.testing.assert_array_equal(like["w"].numpy(), [5.0] * 3)
    assert latest_step(str(tmp_path / "missing")) is None

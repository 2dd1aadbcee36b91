"""The port's ``launch/{mesh, partition, sharding, steps}.py`` and
``models/params.{abstract, logical_axes}`` held to the JAX package's, on
the CPU.

* ``resolve_axes`` against JAX's on ``jax.sharding.AbstractMesh`` (which
  needs no devices): every ParamSpec of all ten archs at full size, the
  parameters' and the optimizer state's shardings
  (``train_state_shardings``), on the meshes ``(16, 16)``,
  ``(2, 16, 16)``, ``(1, 1)`` and ``(4,)`` ``"workers"``, under the default
  rules and ``serve_rules(cfg)``.  The port's parameters are one block per
  layer where the JAX package stacks them on a leading ``"layers"`` axis,
  which no rule shards: a port spec is the JAX spec without its first
  entry (``convert.jax_layout`` pairs them).
* ``cache_sharding_rules`` on every arch's abstract decode caches at
  ``decode_32k``; ``batch_shardings``, ``mentions`` and ``grad_accum_for``
  over archs × ``SHAPES`` × meshes, with and without ``REPRO_GRAD_ACCUM``;
  ``abstract_inputs``' shapes and dtypes for every arch × shape;
  ``abstract`` and ``logical_axes`` for every arch.
* The two cases of ``tests/test_substrate.py::TestShardingRules``, mirrored.
* Local shard shapes and global offsets under a ``fake`` process group of
  256 and 512 ranks (a subprocess: the group is global state), from
  DTensors on ``meta``, against ``NamedSharding(AbstractMesh, spec).
  shard_shape`` and against JAX's own split on a mesh of as many CPU
  devices (``devices_indices_map``, a second subprocess).
* The mesh builders raise without a process group (here, none is made).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding, PartitionSpec

from repro.configs import get_config as jax_config
from repro.configs.base import SHAPES as JAX_SHAPES
from repro.launch import partition as JP
from repro.launch import sharding as JSH
from repro.launch import steps as JS
from repro.models import build_model as jax_build
from repro.models.params import abstract as jax_abstract
from repro.models.params import logical_axes as jax_logical_axes
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import SHAPES
from repro_torch.convert import jax_layout
from repro_torch.launch import partition as P
from repro_torch.launch import sharding as SH
from repro_torch.launch import steps as S
from repro_torch.models import build_model
from repro_torch.models.params import abstract, logical_axes

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "1x1": ((1, 1), ("data", "model")),
          "workers4": ((4,), ("workers",))}
ARCHS = sorted(ARCH_IDS)


def _abstract_mesh(name: str) -> AbstractMesh:
    shape, names = MESHES[name]
    return AbstractMesh(shape, names)


def _sizes(name: str) -> dict:
    shape, names = MESHES[name]
    return dict(zip(names, shape))


def _key(k) -> str:
    for attr in ("key", "idx", "name"):
        if hasattr(k, attr):
            return str(getattr(k, attr))
    return str(k)


def _jax_flat(tree, is_leaf=None) -> dict:
    """{"a/b/0/c": leaf} of a JAX tree, keys as JAX sorts them."""
    return {"/".join(_key(k) for k in path): leaf
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree, is_leaf=is_leaf)}


def _flat(tree, prefix: str = "") -> dict:
    """{"a/b/0/c": leaf} of the port's tree of dicts and lists."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}{k}/"))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}{i}/"))
        return out
    return {prefix[:-1]: tree}


def _padded(spec, ndim: int) -> tuple:
    return tuple(spec) + (None,) * (ndim - len(tuple(spec)))


def _trim(spec) -> tuple:
    spec = list(spec)
    while spec and spec[-1] is None:
        spec.pop()
    return tuple(spec)


def _is_jax_sharding(x) -> bool:
    return isinstance(x, NamedSharding)


# ---------------------------------------------------------------------------
# resolve_axes and the train state's shardings
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("serve", [False, True], ids=["default", "serve_rules"])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_resolve_axes_and_train_state_shardings_match_jax(arch, mesh, serve):
    jcfg, cfg = jax_config(arch), get_config(arch)
    jrules = JS.serve_rules(jcfg) if serve else None
    rules = S.serve_rules(cfg) if serve else None
    assert jrules == rules
    jmesh, sizes = _abstract_mesh(mesh), _sizes(mesh)
    # every ParamSpec of the JAX package's tree, through both resolvers
    jspecs = _jax_flat(jax_build(jcfg).specs(), is_leaf=lambda v: hasattr(v, "axes"))
    for path, s in jspecs.items():
        want = tuple(JP.resolve_axes(s.axes, s.shape, jmesh, jrules))
        assert P.resolve_axes(s.axes, s.shape, sizes, rules) == want, path
    # the train state: parameters one block per layer, the optimizer state stacked
    jparams, jstate = (_jax_flat(t, _is_jax_sharding)
                       for t in JS.train_state_shardings(jcfg, jmesh, jrules))
    params, state = S.train_state_shardings(cfg, sizes, rules)
    layout = jax_layout(build_model(cfg, device="meta"))
    named = S._named(params)
    assert set(named) == set(layout)
    for name, sh in named.items():
        key, index, _ = layout[name]
        want = tuple(jparams[key].spec)
        if index is not None:
            want = _trim(_padded(want, 1)[1:])
        assert sh.spec == want, name
    state = _flat(state)
    assert set(state) == set(jstate)
    for path, sh in state.items():
        assert sh.spec == tuple(jstate[path].spec), path


def test_substrate_sharding_rules_mirrored():
    """``tests/test_substrate.py::TestShardingRules``: on a one-rank
    ``model`` axis a mapping is kept (7 % 1 == 0), and no mesh axis is used
    twice in one spec."""
    one = {"model": 1}
    assert P.resolve_axes(("vocab",), (7,), one) == ("model",)
    assert P.resolve_axes(("heads",), (7,), one) == ("model",)
    spec = P.resolve_axes(("q_proj", "mlp"), (16, 16), {"data": 1, "model": 1})
    flat = [e for e in spec if e is not None]
    assert len(set(flat)) == len(flat)
    # and the cases JAX's resolver decides the same way at real sizes
    for axes, shape, mesh in [(("q_proj", "mlp"), (16, 16), "16x16"),
                              (("heads",), (7,), "16x16"),
                              (("embed", "vocab"), (5120, 131072), "2x16x16"),
                              (("batch", None), (1, 7), "2x16x16")]:
        assert P.resolve_axes(axes, shape, _sizes(mesh)) == tuple(
            JP.resolve_axes(axes, shape, _abstract_mesh(mesh)))


# ---------------------------------------------------------------------------
# caches, batches, grad accumulation, abstract inputs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_cache_sharding_rules_match_jax(arch):
    shape = next(s for s in SHAPES if s.name == "decode_32k")
    jshape = next(s for s in JAX_SHAPES if s.name == "decode_32k")
    caches = S.abstract_inputs(get_config(arch), shape)["caches"]
    jcaches = JS.abstract_inputs(jax_config(arch), jshape)["caches"]
    for mesh in MESHES:
        want = _jax_flat(JSH.cache_sharding_rules(_abstract_mesh(mesh), jcaches),
                         _is_jax_sharding)
        got = _flat(SH.cache_sharding_rules(_sizes(mesh), caches))
        assert set(got) == set(want)
        for path, sh in got.items():
            assert sh.spec == tuple(want[path].spec), (mesh, path)


@pytest.mark.parametrize("arch", ARCHS)
def test_batch_shardings_mentions_and_grad_accum_match_jax(arch, monkeypatch):
    cfg, jcfg = get_config(arch), jax_config(arch)
    for shape, jshape in zip(SHAPES, JAX_SHAPES):
        if shape.kind == "decode":
            continue
        batch = S.abstract_inputs(cfg, shape)
        jbatch = JS.abstract_inputs(jcfg, jshape)
        for mesh in MESHES:
            jmesh, sizes = _abstract_mesh(mesh), _sizes(mesh)
            want = _jax_flat(JSH.batch_shardings(jmesh, jbatch), _is_jax_sharding)
            got = _flat(SH.batch_shardings(sizes, batch))
            assert set(got) == set(want)
            for path, sh in got.items():
                assert sh.spec == tuple(want[path].spec)
                for axis in ("pod", "data", "model", "workers"):
                    assert P.mentions(sh.spec, axis) == JP.mentions(want[path].spec, axis)
    for env in (None, "4", "3", "64"):
        if env is None:
            monkeypatch.delenv("REPRO_GRAD_ACCUM", raising=False)
        else:
            monkeypatch.setenv("REPRO_GRAD_ACCUM", env)
        for shape, jshape in zip(SHAPES, JAX_SHAPES):
            assert S.grad_accum_for(cfg, shape, None) == JS.grad_accum_for(jcfg, jshape, None)
            for mesh in MESHES:
                assert (S.grad_accum_for(cfg, shape, _sizes(mesh))
                        == JS.grad_accum_for(jcfg, jshape, _abstract_mesh(mesh))), (env, mesh)


@pytest.mark.parametrize("shape", [s.name for s in SHAPES])
@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_inputs_match_jax(arch, shape):
    cfg, jcfg = get_config(arch), jax_config(arch)
    got = _flat(S.abstract_inputs(cfg, next(s for s in SHAPES if s.name == shape)))
    want = _jax_flat(JS.abstract_inputs(jcfg, next(s for s in JAX_SHAPES if s.name == shape)))
    assert set(got) == set(want)
    for path, t in got.items():
        assert t.device.type == "meta"
        assert tuple(t.shape) == tuple(want[path].shape), path
        assert str(t.dtype).removeprefix("torch.") == str(want[path].dtype), path


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_and_logical_axes_match_jax(arch):
    cfg = get_config(arch)
    model = build_model(cfg, device="meta")
    specs = model.specs()
    jspecs = jax_build(jax_config(arch)).specs()
    jabs, jaxes = _jax_flat(jax_abstract(jspecs)), _jax_flat(
        jax_logical_axes(jspecs), is_leaf=lambda v: isinstance(v, tuple))
    tensors, axes = S._named(abstract(specs)), S._named(logical_axes(specs))
    for name, (key, index, stacked) in jax_layout(model).items():
        t, want = tensors[name], jabs[key]
        lead = (stacked,) if index is not None else ()
        assert t.device.type == "meta"
        assert lead + tuple(t.shape) == tuple(want.shape), name
        assert str(t.dtype).removeprefix("torch.") == str(want.dtype), name
        assert (("layers",) if index is not None else ()) + tuple(axes[name]) == jaxes[key]
    # the optimizer state's abstract tree, stacked as the JAX package's
    state = _flat(S.abstract_train_state(cfg)[1])
    jstate = _jax_flat(JS.abstract_train_state(jax_config(arch))[1])
    assert set(state) == set(jstate)
    for path, t in state.items():
        assert tuple(t.shape) == tuple(jstate[path].shape) and t.dtype == torch.float32


# ---------------------------------------------------------------------------
# local shapes and offsets under a fake process group
# ---------------------------------------------------------------------------

FAKE_RANKS = {False: [0, 37, 200, 255], True: [0, 37, 300, 511]}
JAX_SPLIT = """
import json, sys
import jax
from repro.configs import get_config
from repro.launch import steps as S
arch, multi, ranks = sys.argv[1], sys.argv[2] == "1", json.loads(sys.argv[3])
shape = (2, 16, 16) if multi else (16, 16)
names = ("pod", "data", "model") if multi else ("data", "model")
n = 512 if multi else 256
mesh = jax.make_mesh(shape, names, devices=jax.devices()[:n])
cfg = get_config(arch)
def flat(tree, is_leaf=None):
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in p): v
            for p, v in jax.tree_util.tree_leaves_with_path(tree, is_leaf=is_leaf)}
shapes = [flat(t) for t in S.abstract_train_state(cfg)[:2]]
shards = [flat(t, lambda v: isinstance(v, jax.sharding.NamedSharding))
          for t in S.train_state_shardings(cfg, mesh)]
out = {}
for which, (sh, sd) in enumerate(zip(shapes, shards)):
    for path, leaf in sh.items():
        idx = sd[path].devices_indices_map(tuple(leaf.shape))
        out[f"{which}:{path}"] = {str(r): [s.start or 0 for s in idx[mesh.devices.flat[r]]]
                                  for r in ranks}
print(json.dumps(out))
"""


@pytest.mark.parametrize("multi_pod", [False, True], ids=["256", "512"])
@pytest.mark.parametrize("arch", ["mistral-nemo-12b", "phi3.5-moe-42b-a6.6b"])
def test_local_shapes_and_offsets_under_a_fake_group(arch, multi_pod, tmp_path):
    ranks = FAKE_RANKS[multi_pod]
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": f"--xla_force_host_platform_device_count={512 if multi_pod else 256}"}
    out = tmp_path / "torch.json"
    port = subprocess.run([sys.executable, str(ROOT / "tests" / "_torch_ranks.py"), "layout",
                           arch, str(int(multi_pod)), json.dumps(ranks), str(out)],
                          capture_output=True, text=True, env=env, timeout=120)
    assert port.returncode == 0, port.stderr[-3000:]
    split = subprocess.run([sys.executable, "-c", JAX_SPLIT, arch, str(int(multi_pod)),
                            json.dumps(ranks)], capture_output=True, text=True, env=env,
                           timeout=120)
    assert split.returncode == 0, split.stderr[-3000:]
    want_offsets = json.loads(split.stdout.strip().splitlines()[-1])
    got = json.loads(out.read_text())
    # JAX's shard_shape on an AbstractMesh of the same shape
    jcfg = jax_config(arch)
    shape, names = MESHES["2x16x16" if multi_pod else "16x16"]
    jmesh = AbstractMesh(shape, names)
    jshapes = [_jax_flat(t) for t in JS.abstract_train_state(jcfg)[:2]]
    jshards = [_jax_flat(t, _is_jax_sharding) for t in JS.train_state_shardings(jcfg, jmesh)]
    layout = jax_layout(build_model(get_config(arch), device="meta"))
    checked = 0
    for name, rec in got.items():
        which, path = name.split(":", 1)
        if which == "0":                      # a parameter: one block of a stacked leaf
            key, index, _ = layout[path]
            jkey, lead = f"0:{key}", int(index is not None)
            want_local = jshards[0][key].shard_shape(tuple(jshapes[0][key].shape))
        else:
            jkey, lead = name, 0
            want_local = jshards[1][path].shard_shape(tuple(jshapes[1][path].shape))
        for r in map(str, ranks):
            assert tuple(rec["local"][r]) == tuple(want_local[lead:]), (name, r)
            assert tuple(rec["offset"][r]) == tuple(want_offsets[jkey][r][lead:]), (name, r)
            checked += 1
    assert checked >= 4 * 100


# ---------------------------------------------------------------------------
# the mesh builders
# ---------------------------------------------------------------------------

def test_mesh_builders_raise_without_a_group():
    from repro_torch.launch.mesh import make_production_mesh, make_worker_mesh
    assert not torch.distributed.is_initialized()
    for make, n in [(lambda: make_production_mesh(), 256),
                    (lambda: make_production_mesh(multi_pod=True), 512),
                    (lambda: make_worker_mesh(12), 12)]:
        with pytest.raises(ValueError, match=f"needs {n} ranks; there is no initialised"):
            make()
    assert not torch.distributed.is_initialized()


def test_named_sharding_shard_shape():
    sizes = _sizes("2x16x16")
    sh = SH.NamedSharding(sizes, (("pod", "data"), "model"))
    assert sh.shard_shape((5120, 14336)) == (160, 896)
    want = PartitionSpec(("pod", "data"), "model")
    assert NamedSharding(_abstract_mesh("2x16x16"), want).shard_shape((5120, 14336)) == (160, 896)
    assert SH.NamedSharding(sizes, ()).shard_shape((3, 5)) == (3, 5)
    assert np.prod(sh.shard_shape((5120, 14336))) * 512 == 5120 * 14336

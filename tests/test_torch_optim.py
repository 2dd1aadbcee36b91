"""The port's optimizers held to the JAX package's ``repro.optim``, on the CPU.

Each of AdamW, Adafactor and momentum SGD takes the same three steps from
the same parameters with the same gradients (numpy, from a seed) in both
packages, in float32 and in bfloat16 parameters; after every step the
parameters and the float32 state must agree.  One leaf of the tree is a
stack, which the port holds as a list of per-layer tensors (a group), as it
holds an LM's stacked layers.  Then Adafactor on nemotron-4-340b's reduced
config: the port's per-layer parameters, grouped as the JAX package stacks
them (``repro_torch.convert.group``), against the JAX package's stacked tree, leaf by
leaf through ``repro_torch.convert``.  The last tests mirror
``tests/test_substrate.py::TestOptimizers``.

Tolerances: float32 state and parameters within 2e-6 of the largest value
of their leaf (the same float32 operations; XLA may fuse a multiply-add and
reduces a mean in another order, each worth an ulp or two); a bfloat16
parameter within one bfloat16 rounding of that leaf's scale (2**-8), since
an ulp of float32 difference can round the update to the neighbouring
bfloat16 value.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cuda import cuda, jax_on_cpu  # noqa: F401  (fixtures)
from repro.configs import get_config as jax_config
from repro.models import build_model as jax_build
from repro.models.params import initialize as jax_initialize
from repro.optim.optimizer import make_optimizer as jax_optimizer
from repro_torch.configs import get_config
from repro_torch.convert import group, lm_params_from_jax, unstack
from repro_torch.models import build_model
from repro_torch.models.params import ParamSpec
from repro_torch.optim.optimizer import make_optimizer

pytestmark = pytest.mark.usefixtures("jax_on_cpu")   # the JAX reference on the CPU

torch.set_num_threads(1)

F32_TOL = 2e-6
BF16_TOL = 2.0 ** -8
NAMES = ["adamw", "adafactor", "sgdm"]
SHAPES = {"w": (3,), "m": (4, 5), "stack": (3, 4, 6)}    # "stack" is a group of 3 (4, 6)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def _close(got: np.ndarray, want: np.ndarray, tol: float, what: str) -> None:
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got.astype(np.float64) - want.astype(np.float64)).max())
    assert err <= tol * scale, f"{what}: error {err:.3e} > {tol} x {scale:.3e}"


def _port_groups(tree: dict, dtype, device) -> dict:
    """The numpy tree as the port's groups: "stack" as a list of members.

    A copy, never a view: ``jnp.asarray`` of a 64-byte aligned numpy array
    on the CPU shares its buffer, and the JAX update is dispatched
    asynchronously, so the port's in-place update of a view could write the
    parameters the JAX update has yet to read."""
    out = {}
    for k, v in tree.items():
        t = torch.tensor(np.asarray(v, np.float32), device=device).to(dtype)
        out[k] = list(t.unbind(0)) if k == "stack" else t
    return out


def _flat_state(state) -> dict:
    """The JAX package's state tree as {key: {"_s_...": array}}, keys "/"-joined."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(state)[0]:
        keys = [str(getattr(k, "key", getattr(k, "idx", k))) for k in path]
        out.setdefault("/".join(keys[:-1]), {})[keys[-1]] = np.asarray(leaf)
    return out


def _check(port_params: dict, port_state: dict, jparams, jstate, dtype, what: str) -> None:
    ptol = F32_TOL if dtype == torch.float32 else BF16_TOL
    for k, want in jax.tree_util.tree_flatten_with_path(jparams)[0]:
        key = "/".join(str(getattr(p, "key", p)) for p in k)
        got = port_params[key]
        got = _np(torch.stack(got)) if isinstance(got, list) else _np(got)
        _close(got, np.asarray(want, np.float32), ptol, f"{what}: parameter {key}")
    jflat = _flat_state(jstate)
    assert sorted(jflat) == sorted(port_state)
    for key, fields in jflat.items():
        assert sorted(fields) == sorted(port_state[key])
        for name, want in fields.items():
            got = port_state[key][name]
            assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
            _close(_np(got), want, F32_TOL, f"{what}: state {key}/{name}")


def _three_steps(name: str, dtype, device="cpu"):
    rng = np.random.default_rng(0)
    tree = {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jparams = {k: jnp.asarray(v, jdtype) for k, v in tree.items()}
    jopt, opt = jax_optimizer(name, lr=0.05), make_optimizer(name, lr=0.05)
    jstate = jopt.init(jparams)
    params = _port_groups(tree, dtype, device)
    state = opt.init(params)
    for step in range(3):
        grads = {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
        jparams, jstate = jax.jit(jopt.update)(
            {k: jnp.asarray(v, jdtype) for k, v in grads.items()}, jstate, jparams,
            jnp.int32(step))
        assert opt.update(_port_groups(grads, dtype, device), state, params, step) is None
        _check(params, state, jparams, jstate, dtype,
               f"{name} {dtype} step {step}")
        for k, v in params.items():
            for t in (v if isinstance(v, list) else [v]):
                assert t.dtype == dtype


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", NAMES)
def test_three_steps_match_jax(name, dtype):
    _three_steps(name, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", NAMES)
def test_three_steps_match_jax_on_the_card(cuda, name, dtype):  # noqa: F811
    _three_steps(name, dtype, cuda)


def _nemotron(device="cpu"):
    cfg = get_config("nemotron-4-340b").reduced()
    assert cfg.optimizer == "adafactor"
    jm = jax_build(jax_config("nemotron-4-340b").reduced())
    jparams = jax_initialize(jm.specs(), jax.random.PRNGKey(0))
    model = lm_params_from_jax(jax.tree.map(np.asarray, jparams),
                               build_model(cfg, device=device))
    return model, jparams


def _random_like(tree, rng):
    return jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32), tree)


def _adafactor_on_nemotron(device="cpu"):
    model, jparams = _nemotron(device)
    rng = np.random.default_rng(1)
    jopt, opt = jax_optimizer("adafactor", lr=1e-2), make_optimizer("adafactor", lr=1e-2)
    jstate = jopt.init(jparams)
    groups = group(dict(model.named_parameters()), model)
    # the stacked slot of the JAX tree: one group of num_layers members
    assert isinstance(groups["slots/s0/norm1/scale"], list)
    assert len(groups["slots/s0/norm1/scale"]) == model.cfg.num_layers
    state = opt.init(groups)
    for step in range(3):
        jgrads = _random_like(jparams, rng)
        jparams, jstate = jax.jit(jopt.update)(jgrads, jstate, jparams, jnp.int32(step))
        grads = {name: torch.as_tensor(a, device=device)
                 for name, a in unstack(jgrads, model).items()}
        opt.update(group(grads, model), state, groups, step)
        want = unstack(jax.tree.map(np.asarray, jparams), model)
        for name, p in model.named_parameters():
            _close(_np(p), want[name], F32_TOL, f"step {step}: {name}")
        jflat = _flat_state(jstate)
        assert sorted(jflat) == sorted(state)
        for key, fields in jflat.items():
            for field, value in fields.items():
                assert tuple(state[key][field].shape) == value.shape
                _close(_np(state[key][field]), value, F32_TOL, f"step {step}: {key}/{field}")


def test_adafactor_on_the_jax_stacking():
    """nemotron-4-340b (reduced) takes Adafactor: the port's grouped update
    is the JAX package's on its stacked tree, parameters and the factored
    state ((n_periods,) row moments of a stacked norm scale, its column
    moment shared across the layers) alike."""
    _adafactor_on_nemotron()


def test_adafactor_layer_by_layer_would_differ():
    """The trap the grouping avoids: one step of Adafactor applied to each
    layer's tensor alone gives other parameters than the stacked leaf's."""
    model, jparams = _nemotron()
    jgrads = _random_like(jparams, np.random.default_rng(1))
    jopt = jax_optimizer("adafactor", lr=1e-2)
    want, _ = jax.jit(jopt.update)(jgrads, jopt.init(jparams), jparams, jnp.int32(0))
    want = unstack(jax.tree.map(np.asarray, want), model)
    grads = {name: torch.as_tensor(a) for name, a in unstack(jgrads, model).items()}
    params = dict(model.named_parameters())
    opt = make_optimizer("adafactor", lr=1e-2)
    opt.update(grads, opt.init(params), params, 0)     # every tensor its own group
    errs = {name: float(np.abs(_np(p) - want[name]).max() / np.abs(want[name]).max())
            for name, p in params.items()}
    assert errs["layers.0.norm1.scale"] > 100 * F32_TOL
    assert errs["embed.embedding"] <= F32_TOL        # an unstacked leaf is the same alone


@pytest.mark.cuda
def test_adafactor_on_the_jax_stacking_on_the_card(cuda):  # noqa: F811
    _adafactor_on_nemotron(cuda)


@pytest.mark.parametrize("name", NAMES)
def test_reduces_quadratic(name):
    """tests/test_substrate.py::TestOptimizers::test_reduces_quadratic."""
    opt = make_optimizer(name, lr=0.1)
    params = {"w": torch.tensor([3.0, -2.0, 1.0]), "m": torch.ones(4, 5) * 2.0}
    state = opt.init(params)

    def loss(p):
        return torch.sum(p["w"] ** 2) + torch.sum(p["m"] ** 2)

    l0 = float(loss(params))
    for step in range(60):
        grads = {k: 2 * v for k, v in params.items()}     # the gradient of the sum of squares
        opt.update(grads, state, params, step)
    assert float(loss(params)) < 0.1 * l0


def _spec_shapes(tree) -> list:
    return [tuple(leaf.shape) for leaf in jax.tree_util.tree_leaves(
        tree, is_leaf=lambda x: isinstance(x, (ParamSpec, torch.Tensor)))]


@pytest.mark.parametrize("name", NAMES)
def test_state_specs_match_init(name):
    """tests/test_substrate.py::TestOptimizers::test_state_specs_match_init,
    and the same for a list of specs, which is a stacked group."""
    opt = make_optimizer(name)
    specs = {"a": ParamSpec((8, 16), ("embed", "mlp")), "b": ParamSpec((4,), (None,)),
             "c": [ParamSpec((5, 6), ("embed", "mlp"))] * 3}
    params = {"a": torch.zeros(8, 16), "b": torch.zeros(4), "c": [torch.zeros(5, 6)] * 3}
    state = opt.init(params)
    spec_state = opt.state_specs(specs)
    assert _spec_shapes(state) == _spec_shapes(spec_state)
    assert all(s.dtype == torch.float32 for s in jax.tree_util.tree_leaves(
        spec_state, is_leaf=lambda x: isinstance(x, ParamSpec)))


def test_adafactor_memory_is_sublinear():
    """tests/test_substrate.py::TestOptimizers::test_adafactor_memory_is_sublinear."""
    state = make_optimizer("adafactor").init({"w": torch.zeros(1024, 1024)})
    assert sum(t.numel() for fields in state.values() for t in fields.values()) == 2048


def test_unknown_optimizer_raises():
    with pytest.raises(ValueError, match="unknown optimizer"):
        make_optimizer("lion")
    assert math.isclose(make_optimizer("sgdm", lr=0.5).lr, 0.5)

"""The port's MoE and recurrent blocks held to the JAX package's, block by
block, on the CPU.

* ``moe_apply``: the router's gates at 1e-6 and its top-k experts equal
  (a flip from a near-tie would be reported with the two gates), then the
  block's output at rtol = atol = 1e-4 without drops (capacity factor 8),
  with drops (factor 0.5, asserting that some pairs were dropped), over a
  sequence of 640 (two segments of 320), at 16 experts, and with the
  ``wi`` (GELU) experts; ``load_balancing_loss``.
* ``mamba_apply``/``mamba_decode``, ``mlstm_apply``/``mlstm_decode`` and
  ``slstm_apply``/``slstm_decode``: the full sequence over several chunks
  with ``return_state``, then decode steps from that state, outputs and
  states at 1e-4.

The parameters are drawn with numpy from a seed, the same for both sides.
The ``cuda`` twins run the port on the card in float32 against the same
JAX reference on the CPU (``jax_on_cpu``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cuda import cuda, jax_on_cpu  # noqa: F401  (fixtures)
from repro.configs import get_config as jax_config
from repro.models import moe as JMOE
from repro.models import ssm as JSSM
from repro_torch.configs import get_config
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM

pytestmark = pytest.mark.usefixtures("jax_on_cpu")   # the JAX reference on the CPU

torch.set_num_threads(1)   # small shapes; leave the cores to the timing-sensitive cluster tests

TOL = 1e-4          # float32 blocks, sums in another order
GATE_TOL = 1e-6     # the router's float32 softmax


def _configs(arch: str, **changes):
    """(the port's, the JAX package's) reduced config of ``arch``."""
    return (dataclasses.replace(get_config(arch).reduced(), **changes),
            dataclasses.replace(jax_config(arch).reduced(), **changes))


def _params(specs, seed: int, scale: float = 0.5):
    """Random float32 parameters for a spec dict, as numpy arrays; the
    fan-in scaled like "scaled_normal", the vectors (decays, biases) of
    order one."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, spec in specs.items():
        fan_in = spec.shape[-2] if len(spec.shape) >= 2 else 1
        out[name] = (rng.standard_normal(spec.shape) * scale / np.sqrt(fan_in)).astype(np.float32)
    return out


def _both(params, device):
    return ({k: jnp.asarray(v) for k, v in params.items()},
            {k: torch.as_tensor(v, device=device) for k, v in params.items()})


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

MOE_CASES = {
    "no-drops": (dict(moe_capacity_factor=8.0), 2, 24),
    "drops": (dict(moe_capacity_factor=0.5), 2, 24),
    "two-segments": (dict(), 1, 640),
    "sixteen-experts": (dict(num_experts=16), 4, 1),
    "gelu-experts": (dict(mlp_type="gelu", moe_capacity_factor=0.5), 2, 24),
}


def _dropped_pairs(topk_i: np.ndarray, experts: int, cap: int) -> int:
    """Pairs at or past capacity, counted token-major as GShard counts."""
    seen = np.zeros(experts, int)
    dropped = 0
    for e in topk_i.reshape(-1):
        dropped += seen[e] >= cap
        seen[e] += 1
    return int(dropped)


def _moe_case(case: str, device):
    changes, b, s = MOE_CASES[case]
    cfg, jcfg = _configs("phi3.5-moe-42b-a6.6b", **changes)
    params = _params(MOE.moe_specs(cfg), seed=11, scale=2.0)
    x = np.random.default_rng(12).standard_normal((b, s, cfg.d_model)).astype(np.float32)
    jp, tp = _both(params, device)

    # the router: gates at 1e-6, then the same experts for every token
    want_g = jax.nn.softmax(jnp.asarray(x.reshape(-1, cfg.d_model)) @ jp["router"], -1)
    want_tg, want_ti = jax.lax.top_k(want_g, cfg.experts_per_token)
    gates, topk_g, topk_i = MOE.route(tp, torch.as_tensor(x, device=device).reshape(
        -1, cfg.d_model), cfg)
    _close(gates, want_g, GATE_TOL)
    flips = np.flatnonzero((_np(topk_i) != np.asarray(want_ti)).any(-1))
    assert not flips.size, [(int(t), np.sort(_np(gates)[t])[::-1][:3].tolist()) for t in flips]
    _close(topk_g, want_tg / want_tg.sum(-1, keepdims=True), GATE_TOL)

    want = JMOE.moe_apply(jp, jnp.asarray(x), jcfg)
    got = MOE.moe_apply(tp, torch.as_tensor(x, device=device), cfg)
    assert got.shape == (b, s, cfg.d_model) and got.dtype == torch.float32
    _close(got, want)
    seg = min(s, MOE.MOE_SEGMENT)
    while s % seg:
        seg -= 1
    ti = _np(topk_i).reshape(b, s, -1)
    return sum(_dropped_pairs(ti[:, i:i + seg], cfg.num_experts, MOE.capacity(b * seg, cfg))
               for i in range(0, s, seg))


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_apply_matches_jax(case):
    dropped = _moe_case(case, "cpu")
    assert (dropped > 0) == (case in ("drops", "gelu-experts")), dropped


def test_moe_two_segments_of_320():
    """S = 640 routes in two segments of 320, each with its own capacity:
    the first 320 positions alone give the first half of the output."""
    cfg, _ = _configs("phi3.5-moe-42b-a6.6b")
    tp = {k: torch.as_tensor(v) for k, v in _params(MOE.moe_specs(cfg), seed=11).items()}
    x = torch.as_tensor(np.random.default_rng(13).standard_normal((1, 640, cfg.d_model)),
                        dtype=torch.float32)
    whole = MOE.moe_apply(tp, x, cfg)
    torch.testing.assert_close(whole[:, :320], MOE.moe_apply(tp, x[:, :320], cfg))
    torch.testing.assert_close(whole[:, 320:], MOE.moe_apply(tp, x[:, 320:], cfg))
    assert MOE.capacity(320, cfg) == 200


def test_load_balancing_loss_matches_jax():
    cfg, jcfg = _configs("mixtral-8x22b")
    params = _params(MOE.moe_specs(cfg), seed=14)
    jp, tp = _both(params, "cpu")
    x = np.random.default_rng(15).standard_normal((2, 20, cfg.d_model)).astype(np.float32)
    np.testing.assert_allclose(float(MOE.load_balancing_loss(tp, torch.as_tensor(x), cfg)),
                               float(JMOE.load_balancing_loss(jp, jnp.asarray(x), jcfg)),
                               rtol=1e-6)


# ---------------------------------------------------------------------------
# Mamba-2, mLSTM, sLSTM
# ---------------------------------------------------------------------------

# block: (arch, the port's specs, JAX's apply, the port's apply, JAX's
# decode, the port's decode, sequence, chunk)
BLOCKS = {
    "mamba": ("zamba2-1.2b", SSM.mamba_specs, JSSM.mamba_apply, SSM.mamba_apply,
              JSSM.mamba_decode, SSM.mamba_decode, 32, 8),
    "mlstm": ("xlstm-125m", SSM.mlstm_specs, JSSM.mlstm_apply, SSM.mlstm_apply,
              JSSM.mlstm_decode, SSM.mlstm_decode, 32, 8),
    "slstm": ("xlstm-125m", SSM.slstm_specs, JSSM.slstm_apply, SSM.slstm_apply,
              JSSM.slstm_decode, SSM.slstm_decode, 16, None),
}
DECODE_STEPS = 4


def _block_case(block: str, device):
    arch, specs, japply, tapply, jdecode, tdecode, s, chunk = BLOCKS[block]
    cfg, jcfg = _configs(arch)
    jp, tp = _both(_params(specs(cfg), seed=21, scale=1.0), device)
    b = 2
    x = np.random.default_rng(22).standard_normal((b, s + DECODE_STEPS, cfg.d_model)).astype(
        np.float32)
    kw = {} if chunk is None else {"chunk": chunk}
    want, jstate = japply(jp, jnp.asarray(x[:, :s]), jcfg, return_state=True, **kw)
    got, tstate = tapply(tp, torch.as_tensor(x[:, :s], device=device), cfg, return_state=True,
                         **kw)
    _close(got, want)
    assert sorted(tstate) == sorted(jstate)
    for name in jstate:
        assert tuple(tstate[name].shape) == jstate[name].shape
        assert tstate[name].dtype == torch.float32
        _close(tstate[name], jstate[name])
    # the handoff: decode steps from the full sequence's state
    for t in range(s, s + DECODE_STEPS):
        want, jstate = jdecode(jp, jnp.asarray(x[:, t:t + 1]), jcfg, jstate)
        got, tstate = tdecode(tp, torch.as_tensor(x[:, t:t + 1], device=device), cfg, tstate)
        assert got.shape == (b, 1, cfg.d_model)
        _close(got, want)
        for name in jstate:
            _close(tstate[name], jstate[name])
    return cfg


@pytest.mark.parametrize("block", list(BLOCKS))
def test_recurrent_block_matches_jax(block):
    _block_case(block, "cpu")


@pytest.mark.parametrize("block", ["mamba", "mlstm"])
def test_recurrent_block_on_one_chunk_and_from_zero_state(block):
    """A sequence shorter than the chunk runs as one chunk, and decoding
    from the initial state reproduces the full sequence token by token."""
    arch, specs, _, tapply, _, tdecode, _, _ = BLOCKS[block]
    cfg, _ = _configs(arch)
    tp = {k: torch.as_tensor(v) for k, v in _params(specs(cfg), seed=23, scale=1.0).items()}
    x = torch.as_tensor(np.random.default_rng(24).standard_normal((2, 12, cfg.d_model)),
                        dtype=torch.float32)
    whole = tapply(tp, x, cfg)
    state = {"mamba": SSM.mamba_init_state, "mlstm": SSM.mlstm_init_state}[block](cfg, 2)
    steps = []
    for t in range(12):
        y, state = tdecode(tp, x[:, t:t + 1], cfg, state)
        steps.append(y)
    torch.testing.assert_close(torch.cat(steps, 1), whole, rtol=TOL, atol=TOL)


def test_a_sequence_off_the_chunk_raises():
    """Above CHUNK, S must be a multiple of it: the JAX package's reshape
    fails there, and the port raises rather than pad."""
    for block in ("mamba", "mlstm"):
        arch, specs, _, tapply, *_ = BLOCKS[block]
        cfg, _ = _configs(arch)
        tp = {k: torch.as_tensor(v) for k, v in _params(specs(cfg), seed=25).items()}
        with pytest.raises(ValueError, match="not a multiple of the chunk 128"):
            tapply(tp, torch.zeros(1, 130, cfg.d_model), cfg)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("case", list(MOE_CASES))
def test_cuda_moe_apply_matches_jax(cuda, case):
    dropped = _moe_case(case, cuda)
    assert (dropped > 0) == (case in ("drops", "gelu-experts")), dropped


@pytest.mark.cuda
@pytest.mark.parametrize("block", list(BLOCKS))
def test_cuda_recurrent_block_matches_jax(cuda, block):
    _block_case(block, cuda)

"""Recurrent / state-space blocks on PyTorch: Mamba-2 (SSD), mLSTM and
sLSTM (xLSTM).

The port of the JAX package's ``models/ssm.py``.  All three expose the
same triplet:

* ``*_specs(cfg)``               — ParamSpec tree;
* ``*_apply(p, x, cfg)``         — full-sequence (train / prefill) path,
                                   chunkwise-parallel where the math allows,
                                   with ``return_state`` for the decode
                                   handoff;
* ``*_decode(p, x, cfg, state)`` — single-token step with explicit state,
                                   returning the new state.

The arithmetic and its dtypes follow the JAX package path by path: where
JAX promotes a bfloat16 operand to float32 silently, the port casts it
explicitly (the Mamba-2 prefill convolves in the model dtype, its decode in
float32; the sLSTM's recurrent weights meet its float32 state in float32).
The stabilisers start at ``-1e30``, never ``-inf``, so that a difference of
two of them stays finite.  JAX's three-operand einsums are written as an
elementwise product and one batched matmul, which never builds the
six-dimensional intermediate a left-to-right contraction would.  The scans
across chunks and the sLSTM's scan over time are Python loops, which
autograd differentiates for training.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.launch.partition import constrain, on_batch_shards, on_replicated, split_heads
from repro_torch.models.params import ParamSpec

__all__ = ["CHUNK", "mamba_specs", "mamba_apply", "mamba_init_state", "mamba_decode",
           "mlstm_specs", "mlstm_apply", "mlstm_init_state", "mlstm_decode",
           "slstm_specs", "slstm_apply", "slstm_init_state", "slstm_decode"]

Params = Mapping[str, torch.Tensor]
State = Dict[str, torch.Tensor]

CHUNK = 128
# DTensor has no sharding rule for logsigmoid's backward: run it on gathered values
_logsigmoid = on_replicated(F.logsigmoid)
NEG = -1e30         # the stabilisers' start: finite, so NEG - NEG is 0, not NaN


def _chunks(s: int, chunk: int) -> Tuple[int, int]:
    """(chunk, number of chunks) for a sequence of s: the chunk is
    min(chunk, s), and s must be a multiple of it (the JAX package's
    reshape fails otherwise; the port does not pad)."""
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"a sequence of {s} is not a multiple of the chunk {chunk}")
    return chunk, s // chunk


def _tril(chunk: int, device) -> torch.Tensor:
    return torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=device))


# ===========================================================================
# Mamba-2 (SSD)
# ===========================================================================

def _mamba_dims(cfg: ArchConfig):
    d_inner = cfg.ssm_expand * cfg.d_model
    head_dim = 64
    nheads = d_inner // head_dim
    return d_inner, nheads, head_dim


def mamba_specs(cfg: ArchConfig) -> Dict[str, ParamSpec]:
    d = cfg.d_model
    d_inner, nheads, head_dim = _mamba_dims(cfg)
    n = cfg.ssm_state
    return {
        "in_proj": ParamSpec((d, 2 * d_inner + 2 * n + nheads), ("embed", "mlp"),
                             init="scaled_normal"),
        "conv_w": ParamSpec((cfg.ssm_conv, d_inner + 2 * n), ("conv", "mlp"),
                            init="scaled_normal"),
        "a_log": ParamSpec((nheads,), ("unsharded",), torch.float32, "zeros"),
        "d_skip": ParamSpec((nheads,), ("unsharded",), torch.float32, "ones"),
        "dt_bias": ParamSpec((nheads,), ("unsharded",), torch.float32, "zeros"),
        "out_proj": ParamSpec((d_inner, d), ("mlp", "embed"), init="scaled_normal"),
    }


@on_batch_shards(0, 1, 2, 3)
def _ssd_chunk_scan(xh, dt, b, c, a_log, chunk: int):
    """SSD chunkwise scan (on a mesh, on each rank's batch shard).

    xh: (B, S, H, P) inputs; dt: (B, S, H) positive step sizes; b, c:
    (B, S, N) input/output projections (shared across heads, 1 group);
    a_log: (H,) log-decay parameter.  Returns (B, S, H, P) and the final
    state (B, H, N, P).  Inside: heads lead, (B, nc, H, Q, ·).
    """
    bs, s, h, p = xh.shape
    n = b.shape[-1]
    nc = s // chunk
    # per-step log decay: da = -exp(a_log) * dt  (Mamba-2 scalar-per-head A)
    da = -torch.exp(a_log) * dt                                    # (B, S, H) <= 0

    xc = xh.reshape(bs, nc, chunk, h, p).transpose(2, 3)           # (B,nc,H,Q,P)
    dtc = dt.reshape(bs, nc, chunk, h).transpose(2, 3)             # (B,nc,H,Q)
    cum = torch.cumsum(da.reshape(bs, nc, chunk, h).transpose(2, 3), dim=-1)
    total = cum[..., -1:]                                          # (B,nc,H,1)
    bc = b.reshape(bs, nc, 1, chunk, n)
    cc = c.reshape(bs, nc, 1, chunk, n)

    # --- intra-chunk (quadratic within chunk) ---
    # L[i,j] = exp(cum_i - cum_j) for i >= j else 0; scores[i,j] = c_i · b_j.
    # Masked before the exp: above the diagonal li >= 0 can pass 88 and
    # exp(li) overflow, and the JAX package's where(mask, exp(li), 0) then
    # has a NaN gradient (0 · inf); the forward is the same either way
    li = cum[..., :, None] - cum[..., None, :]                     # (B,nc,H,Q,Q)
    decay = torch.exp(torch.where(_tril(chunk, xh.device), li, -math.inf))
    op = (cc @ bc.transpose(-1, -2)) * decay                       # (B,nc,H,Q,Q)
    y_intra = op @ (xc * dtc[..., None])                           # (B,nc,H,Q,P)

    # --- inter-chunk state passing ---
    # chunk-local state: S_g = Σ_j exp(total - cum_j) dt_j b_j x_jᵀ
    w = torch.exp(total - cum) * dtc                               # (B,nc,H,Q)
    s_loc = bc.transpose(-1, -2) @ (xc * w[..., None])             # (B,nc,H,N,P)
    state = torch.zeros((bs, h, n, p), dtype=s_loc.dtype, device=xh.device)
    prev = []                                                      # the state BEFORE each chunk
    for g in range(nc):
        prev.append(state)
        state = state * torch.exp(total[:, g])[..., None] + s_loc[:, g]
    prev_states = torch.stack(prev, dim=1)                         # (B,nc,H,N,P)

    # contribution of the carried state to each position in its chunk
    y_inter = (cc @ prev_states) * torch.exp(cum)[..., None]       # (B,nc,H,Q,P)
    y = (y_intra + y_inter).transpose(2, 3).reshape(bs, s, h, p)
    return y, state


def _mamba_split(zxbcdt: torch.Tensor, cfg: ArchConfig):
    d_inner, _, _ = _mamba_dims(cfg)
    n = cfg.ssm_state
    return torch.split(zxbcdt, [d_inner, d_inner, n, n, zxbcdt.shape[-1] - 2 * d_inner - 2 * n],
                       dim=-1)


@on_batch_shards(1)
def _causal_conv(w: torch.Tensor, xbc: torch.Tensor):
    """The causal depthwise convolution of xbc (B, S, C) with w (K, C), in
    the model dtype, and xbc left-padded with K - 1 zero positions."""
    s = xbc.shape[1]
    pad = F.pad(xbc, (0, 0, w.shape[0] - 1, 0))
    conv = pad[:, 0:s] * w[0]
    for i in range(1, w.shape[0]):
        conv = conv + pad[:, i:i + s] * w[i]
    return conv, pad


def mamba_apply(p: Params, x: torch.Tensor, cfg: ArchConfig, chunk: int = CHUNK,
                return_state: bool = False):
    """Mamba-2 block, full sequence. x: (B, S, d).

    With ``return_state`` also returns the decode state after position S-1
    (the SSD scan's final state + the conv tail), for an exact
    prefill→decode handoff.
    """
    bsz, s, _ = x.shape
    d_inner, nheads, head_dim = _mamba_dims(cfg)
    n = cfg.ssm_state
    chunk, _ = _chunks(s, chunk)

    # on a mesh, the projection split over the batch alone (DTensor may
    # leave it partial, or split its sequence, where GSPMD would not)
    z, xr, b, c, dt = _mamba_split(constrain(x @ p["in_proj"], ("batch", None, None)), cfg)
    conv, pad = _causal_conv(p["conv_w"], torch.cat([xr, b, c], dim=-1))
    xr, b, c = torch.split(F.silu(conv), [d_inner, n, n], dim=-1)

    dt = F.softplus(dt.float() + p["dt_bias"])
    xh = split_heads(xr, nheads, head_dim).float()
    y, final_state = _ssd_chunk_scan(xh, dt, b.float(), c.float(), p["a_log"], chunk)
    y = y + xh * p["d_skip"][:, None]
    y = (y.reshape(bsz, s, d_inner) * F.silu(z.float())).to(x.dtype)
    out = y @ p["out_proj"]
    if return_state:
        tail = pad[:, s:, :]          # the last (conv - 1) raw xbc inputs
        return out, {"ssm": final_state, "conv": tail.float()}
    return out


def mamba_init_state(cfg: ArchConfig, batch: int, device=None,
                     dtype: torch.dtype = torch.float32) -> State:
    d_inner, nheads, head_dim = _mamba_dims(cfg)
    return {
        "ssm": torch.zeros((batch, nheads, cfg.ssm_state, head_dim), dtype=dtype,
                           device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, d_inner + 2 * cfg.ssm_state),
                            dtype=dtype, device=device),
    }


def mamba_decode(p: Params, x: torch.Tensor, cfg: ArchConfig, state: State
                 ) -> Tuple[torch.Tensor, State]:
    """One-token Mamba-2 step. x: (B, 1, d); the conv in float32."""
    bsz = x.shape[0]
    d_inner, nheads, head_dim = _mamba_dims(cfg)
    n = cfg.ssm_state

    z, xr, b, c, dt = _mamba_split(x[:, 0] @ p["in_proj"], cfg)
    xbc = torch.cat([xr, b, c], dim=-1)                            # (B, D+2N)
    conv_hist = torch.cat([state["conv"], xbc[:, None].float()], dim=1)
    conv = F.silu((conv_hist * p["conv_w"].float()).sum(1))
    xr, b, c = torch.split(conv, [d_inner, n, n], dim=-1)

    dt = F.softplus(dt.float() + p["dt_bias"])                     # (B, H)
    da = torch.exp(-torch.exp(p["a_log"]) * dt)                    # (B, H)
    xh = split_heads(xr, nheads, head_dim)
    ssm = (state["ssm"] * da[:, :, None, None]
           + b[:, None, :, None] * (dt[:, :, None] * xh)[:, :, None, :])
    y = (c[:, None, None, :] @ ssm)[:, :, 0] + xh * p["d_skip"][:, None]
    y = (y.reshape(bsz, d_inner) * F.silu(z.float())).to(x.dtype)
    out = (y @ p["out_proj"])[:, None]
    return out, {"ssm": ssm, "conv": conv_hist[:, 1:]}


# ===========================================================================
# mLSTM (xLSTM matrix-memory block)
# ===========================================================================

def _mlstm_dims(cfg: ArchConfig):
    d_inner = cfg.ssm_expand * cfg.d_model
    nheads = cfg.num_heads
    head_dim = d_inner // nheads
    return d_inner, nheads, head_dim


def mlstm_specs(cfg: ArchConfig) -> Dict[str, ParamSpec]:
    d = cfg.d_model
    d_inner, nheads, _ = _mlstm_dims(cfg)
    return {
        "up_proj": ParamSpec((d, 2 * d_inner), ("embed", "mlp"), init="scaled_normal"),
        "wq": ParamSpec((d_inner, d_inner), ("mlp", "q_proj"), init="scaled_normal"),
        "wk": ParamSpec((d_inner, d_inner), ("mlp", "q_proj"), init="scaled_normal"),
        "wv": ParamSpec((d_inner, d_inner), ("mlp", "q_proj"), init="scaled_normal"),
        "w_i": ParamSpec((d_inner, nheads), ("mlp", "heads"), init="scaled_normal"),
        "w_f": ParamSpec((d_inner, nheads), ("mlp", "heads"), init="scaled_normal"),
        "f_bias": ParamSpec((nheads,), ("unsharded",), torch.float32, "ones"),
        "down_proj": ParamSpec((d_inner, d), ("mlp", "embed"), init="scaled_normal"),
    }


def _mlstm_inputs(p: Params, x: torch.Tensor, cfg: ArchConfig):
    """(q, k, v (..., H, hd), log_i, log_f (..., H), z) of x (..., d), all
    float32 but z."""
    _, nh, hd = _mlstm_dims(cfg)
    xi, z = torch.chunk(x @ p["up_proj"], 2, dim=-1)
    q = split_heads(xi @ p["wq"], nh, hd).float()
    k = split_heads(xi @ p["wk"], nh, hd).float() / math.sqrt(hd)
    v = split_heads(xi @ p["wv"], nh, hd).float()
    log_i = (xi @ p["w_i"]).float()
    log_f = _logsigmoid((xi @ p["w_f"]).float() + p["f_bias"])     # <= 0
    return q, k, v, log_i, log_f, z


def mlstm_apply(p: Params, x: torch.Tensor, cfg: ArchConfig, chunk: int = CHUNK,
                return_state: bool = False):
    """mLSTM full-sequence path (chunkwise parallel, log-space stabilised).

    Recurrence (per head):  C_t = f_t C_{t-1} + i_t v_t k_tᵀ;
    n_t = f_t n_{t-1} + i_t k_t;  h_t = C_t q_t / max(|n_tᵀ q_t|, 1),
    formed as an attention-like computation with the decay matrix
    D[t, j] = logsum_f(t) - logsum_f(j) + log i_j within chunks and a
    scanned (C, n, m) state across chunks, all in float32.  Inside: heads
    lead, (B, nc, H, Q, ·).
    """
    chunk, _ = _chunks(x.shape[1], chunk)
    q, k, v, log_i, log_f, z = _mlstm_inputs(p, x, cfg)
    h, c_st, n_st, m_st = _mlstm_chunks(q, k, v, log_i, log_f, chunk)
    out = (h * F.silu(z.float())).to(x.dtype) @ p["down_proj"]
    if return_state:
        return out, {"c": c_st, "n": n_st, "m": m_st}
    return out


@on_batch_shards(0, 1, 2, 3, 4)
def _mlstm_chunks(q, k, v, log_i, log_f, chunk: int):
    """The mLSTM's chunkwise form over q, k, v (B, S, H, hd) and the log
    gates (B, S, H), float32 (on a mesh, on each rank's batch shard):
    (h (B, S, H·hd), the final C, n and m)."""
    bsz, s, nh, hd = q.shape
    nc = s // chunk

    def heads_first(t):      # (B, S, H, ...) -> (B, nc, H, Q, ...)
        return t.reshape(bsz, nc, chunk, *t.shape[2:]).transpose(2, 3)

    qc, kc, vc, lic, lfc = map(heads_first, (q, k, v, log_i, log_f))
    cum_f = torch.cumsum(lfc, dim=-1)                              # (B,nc,H,Q)
    tot_f = cum_f[..., -1]                                         # (B,nc,H)

    # intra-chunk decay: prod_{r=j+1..t} f_r * i_j = cum_f[t] - cum_f[j] + log_i[j]
    mask = _tril(chunk, q.device)
    dmat = cum_f[..., :, None] - cum_f[..., None, :] + lic[..., None, :]   # (B,nc,H,t,j)
    dmat = torch.where(mask, dmat, -math.inf)
    scores = qc @ kc.transpose(-1, -2)                             # (B,nc,H,t,j)

    # chunk-local state summaries, scaled by exp(tot_f - cum_f[j] + li_j - m_loc)
    w_log = tot_f[..., None] - cum_f + lic                         # (B,nc,H,Q)
    m_loc = w_log.amax(-1)                                         # (B,nc,H)
    w = torch.exp(w_log - m_loc[..., None])
    c_loc = (kc * w[..., None]).transpose(-1, -2) @ vc             # (B,nc,H,hd,hd)
    n_loc = (kc * w[..., None]).sum(-2)                            # (B,nc,H,hd)

    c_st = torch.zeros((bsz, nh, hd, hd), dtype=torch.float32, device=q.device)
    n_st = torch.zeros((bsz, nh, hd), dtype=torch.float32, device=q.device)
    m_st = torch.full((bsz, nh), NEG, dtype=torch.float32, device=q.device)
    c_prev, n_prev, m_prev = [], [], []                            # the carry BEFORE each chunk
    for g in range(nc):
        c_prev.append(c_st)
        n_prev.append(n_st)
        m_prev.append(m_st)
        m_new = torch.maximum(m_st + tot_f[:, g], m_loc[:, g])
        scale_old = torch.exp(m_st + tot_f[:, g] - m_new)
        scale_new = torch.exp(m_loc[:, g] - m_new)
        c_st = c_st * scale_old[..., None, None] + c_loc[:, g] * scale_new[..., None, None]
        n_st = n_st * scale_old[..., None] + n_loc[:, g] * scale_new[..., None]
        m_st = m_new
    c_prev = torch.stack(c_prev, dim=1)                            # (B,nc,H,hd,hd)
    n_prev = torch.stack(n_prev, dim=1)                            # (B,nc,H,hd)
    m_prev = torch.stack(m_prev, dim=1)                            # (B,nc,H)

    # combine intra and inter with a joint stabiliser per t
    m_intra = dmat.amax(-1)                                        # (B,nc,H,t)
    m_inter = cum_f + m_prev[..., None]
    m_tot = torch.clamp_min(torch.maximum(m_intra, m_inter), NEG)

    p_intra = torch.where(mask, torch.exp(dmat - m_tot[..., None]), 0.0)
    sp = scores * p_intra
    h_intra = sp @ vc                                              # (B,nc,H,t,hd)
    nq_intra = sp.sum(-1)                                          # (B,nc,H,t)
    # the normaliser n_t·q_t with the same intra/inter decomposition
    scale_inter = torch.exp(m_inter - m_tot)
    h_inter = (qc @ c_prev) * scale_inter[..., None]
    nq_inter = (qc * n_prev[..., None, :]).sum(-1) * scale_inter

    denom = torch.maximum(torch.abs(nq_intra + nq_inter), torch.exp(-m_tot))  # max(|nᵀq|, 1)·e^-m
    h = (h_intra + h_inter) / denom[..., None]
    return h.transpose(2, 3).reshape(bsz, s, nh * hd), c_st, n_st, m_st


def mlstm_init_state(cfg: ArchConfig, batch: int, device=None) -> State:
    _, nh, hd = _mlstm_dims(cfg)
    return {
        "c": torch.zeros((batch, nh, hd, hd), dtype=torch.float32, device=device),
        "n": torch.zeros((batch, nh, hd), dtype=torch.float32, device=device),
        "m": torch.full((batch, nh), NEG, dtype=torch.float32, device=device),
    }


def mlstm_decode(p: Params, x: torch.Tensor, cfg: ArchConfig, state: State
                 ) -> Tuple[torch.Tensor, State]:
    """One-token mLSTM step (exact recurrent form). x: (B, 1, d)."""
    bsz = x.shape[0]
    d_inner, _, _ = _mlstm_dims(cfg)
    q, k, v, log_i, log_f, z = _mlstm_inputs(p, x[:, 0], cfg)

    m_new = torch.maximum(state["m"] + log_f, log_i)
    sc_old = torch.exp(state["m"] + log_f - m_new)
    sc_new = torch.exp(log_i - m_new)
    c = state["c"] * sc_old[..., None, None] + sc_new[..., None, None] * (
        k[..., :, None] * v[..., None, :])
    n = state["n"] * sc_old[..., None] + sc_new[..., None] * k

    nq = (n * q).sum(-1)
    denom = torch.maximum(torch.abs(nq), torch.exp(-m_new))
    h = (q[..., None, :] @ c)[..., 0, :] / denom[..., None]
    out = (h.reshape(bsz, d_inner) * F.silu(z.float())).to(x.dtype)
    return (out @ p["down_proj"])[:, None], {"c": c, "n": n, "m": m_new}


# ===========================================================================
# sLSTM (xLSTM scalar-memory block) — strictly sequential scan
# ===========================================================================

def slstm_specs(cfg: ArchConfig) -> Dict[str, ParamSpec]:
    d = cfg.d_model
    nh = cfg.num_heads
    hd = d // nh
    return {
        "w_gates": ParamSpec((d, 4 * d), ("embed", "mlp"), init="scaled_normal"),
        # block-diagonal recurrent weights: per head (hd -> 4·hd), replicated
        "r_gates": ParamSpec((nh, hd, 4 * hd), ("heads", None, None), init="scaled_normal"),
        "b_gates": ParamSpec((4 * d,), (None,), torch.float32, "zeros"),
        "out_proj": ParamSpec((d, d), ("embed", "q_proj"), init="scaled_normal"),
    }


def _slstm_step(r32: torch.Tensor, bias: torch.Tensor, carry, xw: torch.Tensor):
    """carry: (h, c, n, m) each (B, NH, hd) float32; xw: (B, NH, 4hd) the
    input gates' pre-activations; r32: (NH, hd, 4hd) float32; bias:
    (NH, 4hd)."""
    h_prev, c_prev, n_prev, m_prev = carry
    rec = torch.bmm(h_prev.transpose(0, 1), r32).transpose(0, 1)   # (B,NH,4hd)
    gates = xw + rec + bias
    zi, fi, ii, oi = torch.chunk(gates, 4, dim=-1)
    z = torch.tanh(zi)
    o = torch.sigmoid(oi)
    log_f = _logsigmoid(fi)
    m_new = torch.maximum(log_f + m_prev, ii)
    i_g = torch.exp(ii - m_new)
    f_g = torch.exp(log_f + m_prev - m_new)
    c_new = f_g * c_prev + i_g * z
    n_new = f_g * n_prev + i_g
    h_new = o * c_new / torch.clamp_min(n_new, 1e-6)
    return h_new, c_new, n_new, m_new


@on_batch_shards(2)
def _slstm_scan(r32: torch.Tensor, bias: torch.Tensor, xw: torch.Tensor):
    """The recurrence over xw (B, S, NH, 4hd) from a zero carry: (hs (B, S,
    NH, hd), the final carry).  Autograd differentiates it step by step;
    the JAX package's custom VJP for this scan (``_slstm_scan_cv``) exists
    to keep a per-step all-reduce of the recurrent weights' gradient off a
    data-parallel mesh, which one card does not have.  On a mesh it runs on
    each rank's batch shard (``on_batch_shards``), not step by step on
    DTensors."""
    bsz, s, nh, hd4 = xw.shape
    zero = torch.zeros((bsz, nh, hd4 // 4), dtype=xw.dtype, device=xw.device)
    carry = (zero, zero, zero, torch.full_like(zero, NEG))
    hs = []
    for t in range(s):
        carry = _slstm_step(r32, bias, carry, xw[:, t])
        hs.append(carry[0])
    return torch.stack(hs, dim=1), carry


@on_batch_shards(2, 3, 4, 5, 6)
def _slstm_decode_step(r32, bias, xw, h, c, n, m):
    """One position of the recurrence (on a mesh, on each rank's batch shard)."""
    return _slstm_step(r32, bias, (h, c, n, m), xw)


def slstm_apply(p: Params, x: torch.Tensor, cfg: ArchConfig, return_state: bool = False):
    """sLSTM full-sequence path: one recurrent step per position."""
    bsz, s, d = x.shape
    nh = cfg.num_heads
    hd = d // nh
    # the gate pre-activations gathered once before the sequential scan
    xw = constrain((x @ p["w_gates"]).float(), ("batch", None, None))
    xw = split_heads(xw, nh, 4 * hd)
    hs, carry = _slstm_scan(p["r_gates"].float(), p["b_gates"].reshape(nh, 4 * hd), xw)
    out = hs.reshape(bsz, s, d).to(x.dtype) @ p["out_proj"]
    if return_state:
        return out, dict(zip("hcnm", carry))
    return out


def slstm_init_state(cfg: ArchConfig, batch: int, device=None) -> State:
    nh = cfg.num_heads
    hd = cfg.d_model // nh
    z = torch.zeros((batch, nh, hd), dtype=torch.float32, device=device)
    return {"h": z, "c": z.clone(), "n": z.clone(), "m": torch.full_like(z, NEG)}


def slstm_decode(p: Params, x: torch.Tensor, cfg: ArchConfig, state: State
                 ) -> Tuple[torch.Tensor, State]:
    """One-token sLSTM step. x: (B, 1, d)."""
    bsz, _, d = x.shape
    nh = cfg.num_heads
    xw = split_heads((x[:, 0] @ p["w_gates"]).float(), nh, 4 * d // nh)
    carry = _slstm_decode_step(p["r_gates"].float(), p["b_gates"].reshape(nh, -1), xw,
                               state["h"], state["c"], state["n"], state["m"])
    out = carry[0].reshape(bsz, d).to(x.dtype) @ p["out_proj"]
    return out[:, None], dict(zip("hcnm", carry))

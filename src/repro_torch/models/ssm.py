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

On a mesh each full-sequence block runs on every rank's batch shard and,
where the model axis divides the heads, its own heads
(``partition.on_local_shards``); a decode step keeps its state placed as
``launch.sharding.cache_sharding_rules`` places it (a state's dim 2 split
over the model axis) and sums the products that dim splits.  Without a
mesh each function is its plain form.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ArchConfig
from repro_torch.launch.partition import (PLAIN, ModelAxis, cache_placements, mesh_of,
                                          on_local_shards, row_split, shards, split_heads)
from repro_torch.models.layers import silu
from repro_torch.models.params import ParamSpec

__all__ = ["CHUNK", "mamba_specs", "mamba_apply", "mamba_init_state", "mamba_decode",
           "mlstm_specs", "mlstm_apply", "mlstm_init_state", "mlstm_decode",
           "slstm_specs", "slstm_apply", "slstm_init_state", "slstm_decode"]

Params = Mapping[str, torch.Tensor]
State = Dict[str, torch.Tensor]

CHUNK = 128
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


def _heads_split(mesh, heads: int) -> bool:
    """Whether ``mesh``'s model axis splits ``heads`` (each rank its own)."""
    ways = ModelAxis(mesh).size if mesh is not None else 1
    return ways > 1 and heads % ways == 0


def _state_dim_split(t) -> bool:
    """Whether a decode state (a DTensor placed by ``partition.cache_spec``)
    has its dim 2 split over the model axis."""
    axis = ModelAxis(t.device_mesh)
    return axis.size > 1 and t.placements[axis.dim].is_shard(2)


def _placed(state: State) -> State:
    """A recurrent block's final state, each tensor on a mesh placed by
    ``partition.cache_spec`` as a decode state; plain tensors as they are."""
    return {k: (t.redistribute(t.device_mesh, cache_placements(t.device_mesh, t.shape))
                if isinstance(t, DTensor) else t) for k, t in state.items()}


def _decode_where(state: State, split: bool):
    """(the placements each state runs a decode step at, the batch-only
    placements of its inputs): the cache's own where its dim 2 is split over
    the model axis (``split``), else the batch alone (the state gathered
    over the axis, then placed back)."""
    some = next(iter(state.values()))
    mesh = some.device_mesh
    batch = shards(mesh, some.shape)
    return ({k: (t.placements if split else shards(mesh, t.shape)) for k, t in state.items()},
            batch)


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


def _ssd_chunk_scan(xh, dt, b, c, a_log, chunk: int):
    """SSD chunkwise scan.

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
    prefill→decode handoff.  On a mesh each rank runs the convolution and
    the scan on its batch shard and, where the model axis divides the
    heads, its own heads (their z, x and dt columns of the projection,
    gathered over the axis, and every head's B and C); the output
    projection's input is then split over the axis as its rows are.
    """
    bsz, s, _ = x.shape
    d_inner, nheads, head_dim = _mamba_dims(cfg)
    n = cfg.ssm_state
    chunk, _ = _chunks(s, chunk)
    zxbcdt = x @ p["in_proj"]
    mesh = mesh_of(zxbcdt)
    split = _heads_split(mesh, nheads)
    mixed = None if mesh is None else shards(mesh, (bsz, s, d_inner), model=2 if split else None)
    tail = None
    if mesh is not None and return_state:
        tail = cache_placements(mesh, (bsz, cfg.ssm_conv - 1, d_inner + 2 * n))
    whole = None if mesh is None else shards(mesh, zxbcdt.shape)
    rep = None if mesh is None else shards(mesh, (nheads,), batch=None)
    conv_rep = None if mesh is None else shards(mesh, p["conv_w"].shape, batch=None)

    def mix(axis, zxbcdt, conv_w, dt_bias, a_log, d_skip):
        h0, h1 = axis.span(nheads, split)
        if (h0, h1) == (0, nheads):
            z, xr, b, c, dt = _mamba_split(zxbcdt, cfg)
        else:       # this rank's heads of z, x and dt, every head's B and C
            cols = lambda a, b: zxbcdt[..., a:b]
            z, xr = cols(h0 * head_dim, h1 * head_dim), cols(d_inner + h0 * head_dim,
                                                              d_inner + h1 * head_dim)
            b, c = cols(2 * d_inner, 2 * d_inner + n), cols(2 * d_inner + n, 2 * d_inner + 2 * n)
            dt = cols(2 * d_inner + 2 * n + h0, 2 * d_inner + 2 * n + h1)
            conv_w = torch.cat([conv_w[:, h0 * head_dim:h1 * head_dim], conv_w[:, d_inner:]], -1)
            dt_bias, a_log, d_skip = dt_bias[h0:h1], a_log[h0:h1], d_skip[h0:h1]
        conv, pad = _causal_conv(conv_w, torch.cat([xr, b, c], dim=-1))
        xr, b, c = torch.split(silu(conv), [xr.shape[-1], n, n], dim=-1)

        dt = F.softplus(dt.float() + dt_bias)
        xh = split_heads(xr, h1 - h0, head_dim).float()
        y, final_state = _ssd_chunk_scan(xh, dt, b.float(), c.float(), a_log, chunk)
        y = y + xh * d_skip[:, None]
        y = (y.reshape(xh.shape[0], s, -1) * F.silu(z.float())).to(x.dtype)
        if not return_state:
            return y, None, None
        if tail is None:                 # the last (conv - 1) raw xbc inputs
            return y, final_state, pad[:, s:, :].float()
        xbc = zxbcdt[..., d_inner:2 * d_inner + 2 * n]
        c0, c1 = axis.span(xbc.shape[-1], tail[axis.dim].is_shard(2))
        raw = F.pad(xbc, (0, 0, cfg.ssm_conv - 1, 0))[:, s:, c0:c1]
        return y, final_state, raw.float()

    state_at = None if mesh is None else shards(mesh, (bsz, nheads, n, head_dim),
                                                model=1 if split else None)
    y, final_state, conv_tail = on_local_shards(
        mix, (zxbcdt, p["conv_w"], p["dt_bias"], p["a_log"], p["d_skip"]),
        (whole, conv_rep, rep, rep, rep), (mixed, state_at, tail))
    out = row_split(y, p["out_proj"])
    if return_state:
        return out, _placed({"ssm": final_state, "conv": conv_tail})
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
    """One-token Mamba-2 step. x: (B, 1, d); the conv in float32.

    On a mesh the state keeps its ``partition.cache_spec`` placement: each
    rank updates its channels of the conv state and its rows (the N dim)
    of the SSM state from the projection gathered over the model axis; the
    convolved channels are gathered, and the C·state products summed over
    the axis and split by head (a reduce-scatter), where the heads divide
    the axis, for the output projection's rows."""
    bsz = x.shape[0]
    d_inner, nheads, head_dim = _mamba_dims(cfg)
    n = cfg.ssm_state
    zxbcdt = x[:, 0] @ p["in_proj"]
    mesh = mesh_of(zxbcdt, *state.values())
    where = batch = rep = conv_at = y_at = None
    split = by_heads = False
    if mesh is not None:
        split = _state_dim_split(state["ssm"])
        by_heads = split and _heads_split(mesh, nheads)
        where, batch = _decode_where(state, split)
        rep = shards(mesh, (1,), batch=None)
        conv_at = shards(mesh, p["conv_w"].shape, batch=None,
                         model=1 if where["conv"][ModelAxis(mesh).dim].is_shard(2) else None)
        y_at = shards(mesh, (bsz, d_inner), model=1 if by_heads else None)

    def step(axis, zxbcdt, conv_state, ssm_state, conv_w, a_log, dt_bias, d_skip):
        z, xr, b, c, dt = _mamba_split(zxbcdt, cfg)
        xbc = torch.cat([xr, b, c], dim=-1)                            # (B, D+2N)
        c0, c1 = axis.span(xbc.shape[-1], conv_state.shape[-1] < xbc.shape[-1])
        if (c0, c1) == (0, xbc.shape[-1]):
            conv_hist = torch.cat([conv_state, xbc[:, None].float()], dim=1)
            conv = F.silu((conv_hist * conv_w.float()).sum(1))
        else:        # this rank's channels of the conv state (and of conv_w)
            conv_hist = torch.cat([conv_state, xbc[:, None, c0:c1].float()], dim=1)
            conv = axis.gather(F.silu((conv_hist * conv_w.float()).sum(1)), 1)
        xr, b, c = torch.split(conv, [d_inner, n, n], dim=-1)

        dt = F.softplus(dt.float() + dt_bias)                          # (B, H)
        da = torch.exp(-torch.exp(a_log) * dt)                         # (B, H)
        xh = split_heads(xr, nheads, head_dim)
        n0, n1 = axis.span(n, split)
        if (n0, n1) == (0, n):
            ssm = (ssm_state * da[:, :, None, None]
                   + b[:, None, :, None] * (dt[:, :, None] * xh)[:, :, None, :])
            y = (c[:, None, None, :] @ ssm)[:, :, 0] + xh * d_skip[:, None]
        else:        # this rank's rows of the state; C·state summed over the axis
            ssm = (ssm_state * da[:, :, None, None]
                   + b[:, None, n0:n1, None] * (dt[:, :, None] * xh)[:, :, None, :])
            y = (c[:, None, None, n0:n1] @ ssm)[:, :, 0]
            h0, h1 = axis.span(nheads, by_heads)
            y = (axis.scatter(y, 1) if by_heads else axis.sum(y)) + (
                xh[:, h0:h1] * d_skip[h0:h1, None])
            z = z[:, h0 * head_dim:h1 * head_dim]
        y = (y.reshape(xr.shape[0], -1) * F.silu(z.float())).to(x.dtype)
        return y, conv_hist[:, 1:], ssm

    y, conv_state, ssm = on_local_shards(
        step, (zxbcdt, state["conv"], state["ssm"], p["conv_w"], p["a_log"], p["dt_bias"],
               p["d_skip"]),
        (batch, where and where["conv"], where and where["ssm"], conv_at) + (rep,) * 3,
        (y_at, where and where["conv"], where and where["ssm"]), batch=batch)
    out = row_split(y, p["out_proj"])[:, None]
    return out, _placed({"ssm": ssm, "conv": conv_state})


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
    """(q, k, v (..., H, hd), log_i, the forget gate's pre-activation (...,
    H), z) of x (..., d), all float32 but z; ``log_f =
    logsigmoid(pre + f_bias)``, taken on each rank's shard."""
    _, nh, hd = _mlstm_dims(cfg)
    xi, z = torch.chunk(x @ p["up_proj"], 2, dim=-1)
    q = split_heads(xi @ p["wq"], nh, hd).float()
    k = split_heads(xi @ p["wk"], nh, hd).float() / math.sqrt(hd)
    v = split_heads(xi @ p["wv"], nh, hd).float()
    log_i = (xi @ p["w_i"]).float()
    return q, k, v, log_i, (xi @ p["w_f"]).float(), z


def mlstm_apply(p: Params, x: torch.Tensor, cfg: ArchConfig, chunk: int = CHUNK,
                return_state: bool = False):
    """mLSTM full-sequence path (chunkwise parallel, log-space stabilised).

    Recurrence (per head):  C_t = f_t C_{t-1} + i_t v_t k_tᵀ;
    n_t = f_t n_{t-1} + i_t k_t;  h_t = C_t q_t / max(|n_tᵀ q_t|, 1),
    formed as an attention-like computation with the decay matrix
    D[t, j] = logsum_f(t) - logsum_f(j) + log i_j within chunks and a
    scanned (C, n, m) state across chunks, all in float32.  Inside: heads
    lead, (B, nc, H, Q, ·).  On a mesh each rank runs its batch shard and,
    where the model axis divides the heads, its own heads.
    """
    chunk, _ = _chunks(x.shape[1], chunk)
    q, k, v, log_i, f_pre, z = _mlstm_inputs(p, x, cfg)
    bsz, s, nh, hd = q.shape
    mesh = mesh_of(q, k, v, log_i, f_pre)
    hw = gw = bw = outs = None
    if mesh is not None:
        split = 2 if _heads_split(mesh, nh) else None
        hw, gw = shards(mesh, q.shape, model=split), shards(mesh, log_i.shape, model=split)
        bw = shards(mesh, (nh,), batch=None, model=split and 0)
        outs = (shards(mesh, (bsz, s, nh * hd), model=split),
                shards(mesh, (bsz, nh, hd, hd), model=split and 1),
                shards(mesh, (bsz, nh, hd), model=split and 1),
                shards(mesh, (bsz, nh), model=split and 1))
    h, c_st, n_st, m_st = on_local_shards(
        lambda axis, q, k, v, log_i, f_pre, f_bias: _mlstm_chunks(
            q, k, v, log_i, F.logsigmoid(f_pre + f_bias), chunk),         # log_f <= 0
        (q, k, v, log_i, f_pre, p["f_bias"]), (hw, hw, hw, gw, gw, bw), outs)
    out = row_split((h * F.silu(z.float())).to(x.dtype), p["down_proj"])
    if return_state:
        return out, _placed({"c": c_st, "n": n_st, "m": m_st})
    return out


def _mlstm_chunks(q, k, v, log_i, log_f, chunk: int):
    """The mLSTM's chunkwise form over q, k, v (B, S, H, hd) and the log
    gates (B, S, H), float32: (h (B, S, H·hd), the final C, n and m)."""
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
    """One-token mLSTM step (exact recurrent form). x: (B, 1, d).

    On a mesh the state keeps its ``partition.cache_spec`` placement: each
    rank updates its rows of C and its part of n (the key dim) from q, k
    and v gathered over the model axis, and the products with q are summed
    over the axis."""
    bsz = x.shape[0]
    d_inner, nh, hd = _mlstm_dims(cfg)
    q, k, v, log_i, f_pre, z = _mlstm_inputs(p, x[:, 0], cfg)
    mesh = mesh_of(q, *state.values())
    where = batch = rep = None
    split = False
    if mesh is not None:
        split = _state_dim_split(state["c"])
        where, batch = _decode_where(state, split)
        rep = shards(mesh, (nh,), batch=None)

    def step(axis, q, k, v, log_i, f_pre, f_bias, c, n, m):
        log_f = F.logsigmoid(f_pre + f_bias)
        m_new = torch.maximum(m + log_f, log_i)
        sc_old = torch.exp(m + log_f - m_new)
        sc_new = torch.exp(log_i - m_new)
        k0, k1 = axis.span(hd, split)
        if (k0, k1) != (0, hd):      # this rank's rows of C and part of n
            k, q = k[..., k0:k1], q[..., k0:k1]
        c = c * sc_old[..., None, None] + sc_new[..., None, None] * (
            k[..., :, None] * v[..., None, :])
        n = n * sc_old[..., None] + sc_new[..., None] * k
        nq = (n * q).sum(-1)
        h = (q[..., None, :] @ c)[..., 0, :]
        if (k0, k1) != (0, hd):
            both = axis.sum(torch.cat([h, nq[..., None]], dim=-1))
            h, nq = both[..., :-1], both[..., -1]
        denom = torch.maximum(torch.abs(nq), torch.exp(-m_new))
        return h / denom[..., None], c, n, m_new

    wc, wn, wm = (None,) * 3 if where is None else (where["c"], where["n"], where["m"])
    h, c, n, m = on_local_shards(
        step, (q, k, v, log_i, f_pre, p["f_bias"], state["c"], state["n"], state["m"]),
        (batch,) * 5 + (rep, wc, wn, wm), (batch, wc, wn, wm), batch=batch)
    out = (h.reshape(bsz, d_inner) * F.silu(z.float())).to(x.dtype)
    return row_split(out, p["down_proj"])[:, None], _placed({"c": c, "n": n, "m": m})


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


def _slstm_step(r32: torch.Tensor, bias: torch.Tensor, carry, xw: torch.Tensor,
                axis: ModelAxis = PLAIN, split: bool = False):
    """carry: (h, c, n, m) each (B, NH, hd) float32; xw: (B, NH, 4hd) the
    input gates' pre-activations; r32: (NH, hd, 4hd) float32; bias:
    (NH, 4hd).  With ``split`` the carry holds this rank's part of hd: the
    recurrent products are summed over ``axis`` and each gate is cut to
    that part."""
    h_prev, c_prev, n_prev, m_prev = carry
    if split:
        j0, j1 = axis.span(r32.shape[1])
        rec = axis.sum(torch.bmm(h_prev.transpose(0, 1), r32[:, j0:j1]).transpose(0, 1))
    else:
        rec = torch.bmm(h_prev.transpose(0, 1), r32).transpose(0, 1)   # (B,NH,4hd)
    gates = xw + rec + bias
    zi, fi, ii, oi = torch.chunk(gates, 4, dim=-1)
    if split:
        zi, fi, ii, oi = (g[..., j0:j1] for g in (zi, fi, ii, oi))
    z = torch.tanh(zi)
    o = torch.sigmoid(oi)
    log_f = F.logsigmoid(fi)
    m_new = torch.maximum(log_f + m_prev, ii)
    i_g = torch.exp(ii - m_new)
    f_g = torch.exp(log_f + m_prev - m_new)
    c_new = f_g * c_prev + i_g * z
    n_new = f_g * n_prev + i_g
    h_new = o * c_new / torch.clamp_min(n_new, 1e-6)
    return h_new, c_new, n_new, m_new


def _slstm_scan(r32: torch.Tensor, bias: torch.Tensor, xw: torch.Tensor):
    """The recurrence over xw (B, S, NH, 4hd) from a zero carry: (hs (B, S,
    NH, hd), the final carry).  Autograd differentiates it step by step;
    the JAX package's custom VJP for this scan (``_slstm_scan_cv``) exists
    to keep a per-step all-reduce of the recurrent weights' gradient off a
    data-parallel mesh, which one card does not have.  On a mesh it runs on
    each rank's shard of the batch and heads (``slstm_apply``), not step
    by step on DTensors."""
    bsz, s, nh, hd4 = xw.shape
    zero = torch.zeros((bsz, nh, hd4 // 4), dtype=xw.dtype, device=xw.device)
    carry = (zero, zero, zero, torch.full_like(zero, NEG))
    hs = []
    for t in range(s):
        carry = _slstm_step(r32, bias, carry, xw[:, t])
        hs.append(carry[0])
    return torch.stack(hs, dim=1), carry


def slstm_apply(p: Params, x: torch.Tensor, cfg: ArchConfig, return_state: bool = False):
    """sLSTM full-sequence path: one recurrent step per position.  On a mesh
    each rank runs the scan on its batch shard and, where the model axis
    divides the heads (the recurrent weights are block-diagonal by head),
    its own heads."""
    bsz, s, d = x.shape
    nh = cfg.num_heads
    hd = d // nh
    xw = split_heads((x @ p["w_gates"]).float(), nh, 4 * hd)
    mesh = mesh_of(xw)
    xw_at = r_at = outs = None
    if mesh is not None:
        split = 2 if _heads_split(mesh, nh) else None
        xw_at = shards(mesh, xw.shape, model=split)
        r_at = shards(mesh, (nh,), batch=None, model=split and 0)
        carry_at = shards(mesh, (bsz, nh, hd), model=split and 1)
        outs = (shards(mesh, (bsz, s, nh, hd), model=split), (carry_at,) * 4)
    hs, carry = on_local_shards(
        lambda axis, r32, bias, xw: _slstm_scan(r32, bias, xw),
        (p["r_gates"].float(), p["b_gates"].reshape(nh, 4 * hd), xw), (r_at, r_at, xw_at),
        outs)
    out = hs.reshape(bsz, s, d).to(x.dtype) @ p["out_proj"]
    if return_state:
        return out, _placed(dict(zip("hcnm", carry)))
    return out


def slstm_init_state(cfg: ArchConfig, batch: int, device=None) -> State:
    nh = cfg.num_heads
    hd = cfg.d_model // nh
    z = torch.zeros((batch, nh, hd), dtype=torch.float32, device=device)
    return {"h": z, "c": z.clone(), "n": z.clone(), "m": torch.full_like(z, NEG)}


def slstm_decode(p: Params, x: torch.Tensor, cfg: ArchConfig, state: State
                 ) -> Tuple[torch.Tensor, State]:
    """One-token sLSTM step. x: (B, 1, d).

    On a mesh the state keeps its ``partition.cache_spec`` placement.  The
    step runs on each rank's heads where the model axis divides them (the
    state resharded to heads and back: the recurrent weights are
    block-diagonal by head, so nothing is summed and no weight gathered),
    else on its part of hd, the recurrent products summed over the axis."""
    bsz, _, d = x.shape
    nh = cfg.num_heads
    xw = split_heads((x[:, 0] @ p["w_gates"]).float(), nh, 4 * d // nh)
    mesh = mesh_of(xw, *state.values())
    where, batch, rep = {k: None for k in "hcnm"}, None, None
    split = False
    if mesh is not None and _heads_split(mesh, nh):
        batch = shards(mesh, xw.shape, model=1)
        where = {k: shards(mesh, t.shape, model=1) for k, t in state.items()}
        rep = shards(mesh, (nh,), batch=None, model=0)
    elif mesh is not None:
        split = _state_dim_split(state["h"])
        where, batch = _decode_where(state, split)
        rep = shards(mesh, (nh,), batch=None)
    carry = on_local_shards(
        lambda axis, r32, bias, xw, *carry: _slstm_step(r32, bias, carry, xw, axis, split),
        (p["r_gates"].float(), p["b_gates"].reshape(nh, -1), xw,
         *(state[k] for k in "hcnm")),
        (rep, rep, batch, *(where[k] for k in "hcnm")),
        None if mesh is None else tuple(where[k] for k in "hcnm"),
        batch=None if mesh is None else shards(mesh, xw.shape))
    h = carry[0]
    if split:
        h = h.redistribute(h.device_mesh, shards(h.device_mesh, h.shape))
    out = h.reshape(bsz, d).to(x.dtype) @ p["out_proj"]
    return out[:, None], _placed(dict(zip("hcnm", carry)))

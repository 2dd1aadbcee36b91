"""Foundational layers: norms, RoPE, GQA attention (blockwise/flash-style),
MLP variants, embeddings, as plain functions on tensors.

The port of the JAX package's ``models/layers.py``; each function keeps its
name, its arguments' layout and its arithmetic (dtypes, the float32
accumulation of attention, the −1e30 mask).  Parameters come in as any
mapping of names to tensors (a dict, or an ``nn.ParameterDict`` of
:class:`repro_torch.models.lm.LM`).  No Pallas kernel is involved, so the
projections are ``torch.matmul`` calls, as the JAX package leaves them to
XLA.

Two differences, neither in the numbers: ``attn_decode`` writes the new
key and value into the cache in place (the JAX function returns new
caches; a full-width cache is too large to copy every token), and a
position outside a full-length cache raises where
``jax.lax.dynamic_update_slice`` would clamp it onto the last slot.
Cross-attention (the encoder-decoder's, ``models/encdec.py``) has no rope:
``cross_attn_apply`` attends over the whole encoder output, and
``cross_attn_decode``, the decode step's cross-attention that the JAX
package writes inline in ``EncDecLM.decode_step``, reads the static
encoder K/V at ``pos = enc_len - 1`` with no window and no softcap.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate

from repro_torch.configs.base import ArchConfig
from repro_torch.launch.partition import (PLAIN, ModelAxis, gathered, mesh_of, on_local_shards,
                                          row_split, shards, split_heads, whole_grads)
from repro_torch.models.params import ParamSpec

Params = Mapping[str, torch.Tensor]

DEFAULT_Q_BLOCK = 512
DEFAULT_KV_BLOCK = 1024


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def norm_spec(cfg: ArchConfig, d: Optional[int] = None) -> Dict[str, ParamSpec]:
    d = d or cfg.d_model
    if cfg.norm_type == "layernorm":
        return {"scale": ParamSpec((d,), ("embed",), torch.float32, "ones"),
                "bias": ParamSpec((d,), ("embed",), torch.float32, "zeros")}
    return {"scale": ParamSpec((d,), ("embed",), torch.float32, "ones")}


def apply_norm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMS norm, or layer norm where ``p`` has a bias; in float32, cast back.
    On a mesh a partial sum (a block's output added to the residual) is
    reduced first, so that the norm, and the projections after it, see
    whole values (DTensor would otherwise carry the partial through the
    scaling and split the next matmul for it); the result's gradient is
    reduced too (``partition.whole_grads``)."""
    if isinstance(x, DTensor) and any(q.is_partial() for q in x.placements):
        x = x.redistribute(x.device_mesh, tuple(Replicate() if q.is_partial() else q
                                                for q in x.placements))
    xf = x.float()
    if "bias" in p:
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        out = (xf - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    else:
        ms = (xf * xf).mean(-1, keepdim=True)
        out = xf * torch.rsqrt(ms + eps) * p["scale"]
    return whole_grads(out.to(x.dtype))


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_tables(positions: torch.Tensor, hd: int,
                theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin), each (1, S, 1, hd // 2) float32, for ``positions`` (S,)."""
    half = hd // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=positions.device) / half)
    ang = positions[:, None].float() * freq                      # (S, half)
    return torch.cos(ang)[None, :, None, :], torch.sin(ang)[None, :, None, :]


def apply_rope(x: torch.Tensor, tables: Tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
    """The half-split (not interleaved) rotation of x (B, S, H, hd)."""
    cos, sin = tables
    half = cos.shape[-1]
    x1, x2 = x[..., :half], x[..., half:2 * half]
    rot = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    if 2 * half < x.shape[-1]:   # odd head_dim tail passes through
        rot = torch.cat([rot, x[..., 2 * half:].to(rot.dtype)], dim=-1)
    return rot.to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (S,) integers, batch-free as in the JAX
    package; angles in float32."""
    return apply_rope(x, rope_tables(positions, x.shape[-1], theta))


# ---------------------------------------------------------------------------
# Attention params
# ---------------------------------------------------------------------------

def attn_specs(cfg: ArchConfig) -> Dict[str, ParamSpec]:
    d, q, kv = cfg.d_model, cfg.q_dim, cfg.kv_dim
    return {
        "wq": ParamSpec((d, q), ("embed", "q_proj"), init="scaled_normal"),
        "wk": ParamSpec((d, kv), ("embed", "kv_proj"), init="scaled_normal"),
        "wv": ParamSpec((d, kv), ("embed", "kv_proj"), init="scaled_normal"),
        "wo": ParamSpec((q, d), ("q_proj", "embed"), init="scaled_normal"),
    }


def _project_qkv(p: Params, x: torch.Tensor, cfg: ArchConfig):
    q = split_heads(x @ p["wq"], cfg.num_heads, cfg.head_dim)
    k = split_heads(x @ p["wk"], cfg.num_kv_heads, cfg.head_dim)
    v = split_heads(x @ p["wv"], cfg.num_kv_heads, cfg.head_dim)
    return q, k, v


def _repeat_kv(k: torch.Tensor, groups: int) -> torch.Tensor:
    """(B, S, KV, hd) -> (B, S, KV*groups, hd) by repetition (GQA)."""
    if groups == 1:
        return k
    return torch.repeat_interleave(k, groups, dim=2)


# ---------------------------------------------------------------------------
# Blockwise (flash-style) attention core
# ---------------------------------------------------------------------------

def _pick_block(s: int, target: int) -> int:
    """Largest divisor of ``s`` that is ≤ ``target``."""
    d = min(target, s)
    while s % d:
        d -= 1
    return max(d, 1)


def _attend_block(q, k, kpos, qpos, causal: bool, window: int,
                  softcap: float, scale: float):
    """Masked float32 logits for one (q-block, kv-block) tile.

    q: (B, H, qb, hd); k: (B, H, kvb, hd); qpos: (qb,), kpos: (kvb,).
    """
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if softcap > 0:
        logits = torch.tanh(logits / softcap) * softcap
    mask = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window > 0:
        mask &= kpos[None, :] > (qpos[:, None] - window)
    return torch.where(mask[None, None], logits, torch.full_like(logits, -1e30))


def _gqa_split(h: int, kvh: int, ways: int) -> Optional[str]:
    """How ``ways`` ranks split the heads of a grouped-query attention:
    ``"kv"`` (the query and KV heads both), ``"q"`` (the query heads; each
    rank takes the KV heads its own query heads use, from KV heads
    replicated on the axis) or None (neither: every rank has every head)."""
    if ways == 1 or h % ways:
        return None
    if kvh % ways == 0:
        return "kv"
    local, groups = h // ways, h // kvh
    return "q" if local % groups == 0 or groups % local == 0 else None


def _kv_span(axis: ModelAxis, h: int, kvh: int) -> Tuple[int, int]:
    """[first, last + 1) of the KV heads this rank's query heads use."""
    q0, q1 = axis.span(h)
    groups = h // kvh
    return q0 // groups, (q1 - 1) // groups + 1


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, window: int = 0,
                        softcap: float = 0.0,
                        q_block: int = DEFAULT_Q_BLOCK,
                        kv_block: int = DEFAULT_KV_BLOCK,
                        q_offset: int = 0) -> torch.Tensor:
    """Memory-bounded attention.  q: (B, S, H, hd); k, v: (B, T, KV, hd).

    An outer loop over query blocks and an inner loop over KV blocks with a
    running max and denominator (the JAX package's two scans), so logits
    are never materialised at (S × T).  ``window > 0`` restricts each query
    to the previous ``window`` keys and the computation to the KV slice
    that covers them.  ``q_offset`` is the absolute position of q[0].

    On a mesh each rank attends with its batch shard and its query heads
    (:func:`_gqa_split`), as GSPMD partitions the JAX package's; the result
    keeps that split.
    """
    kw = dict(causal=causal, window=window, softcap=softcap, q_block=q_block,
              kv_block=kv_block, q_offset=q_offset)
    mesh = mesh_of(q, k, v)
    if mesh is None:
        return _blockwise_attention(q, k, v, **kw)
    h, kvh = q.shape[2], k.shape[2]
    split = _gqa_split(h, kvh, ModelAxis(mesh).size)
    qp = shards(mesh, q.shape, model=2 if split else None)
    kvp = shards(mesh, k.shape, model=2 if split == "kv" else None)

    def attend(axis, q, k, v):
        if split == "q":
            k0, k1 = _kv_span(axis, h, kvh)
            k, v = k[:, :, k0:k1], v[:, :, k0:k1]
        return _blockwise_attention(q, k, v, **kw)
    return on_local_shards(attend, (q, k, v), (qp, kvp, kvp), qp)


def _blockwise_attention(q, k, v, causal, window, softcap, q_block, kv_block, q_offset):
    b, s, h, hd = q.shape
    t = k.shape[1]
    groups = h // k.shape[2]
    k = _repeat_kv(k, groups)
    v = _repeat_kv(v, groups)
    scale = 1.0 / math.sqrt(hd)

    q_block = _pick_block(s, q_block)
    kv_block = _pick_block(t, kv_block)

    qt = q.transpose(1, 2)          # (B, H, S, hd)
    kt = k.transpose(1, 2)          # (B, H, T, hd)
    vt = v.transpose(1, 2)

    if window > 0:
        # KV slice that can ever be attended from one q block
        span = window + q_block
        span = -(-span // kv_block) * kv_block
        span = min(span, t)
    else:
        span = t
    n_kb = span // kv_block

    blocks = []
    for qi in range(s // q_block):
        qpos = q_offset + qi * q_block + torch.arange(q_block, device=q.device)
        qb = qt[:, :, qi * q_block:(qi + 1) * q_block]
        if window > 0:
            # earliest key this block can see, clamped so that the slice
            # stays in range; the mask keeps the semantics exact
            start = min(max(q_offset + qi * q_block - window + 1, 0), t - span)
        else:
            start = 0
        m = torch.full((b, h, q_block), -1e30, dtype=torch.float32, device=q.device)
        l = torch.zeros((b, h, q_block), dtype=torch.float32, device=q.device)
        acc = torch.zeros((b, h, q_block, hd), dtype=torch.float32, device=q.device)
        for kj in range(n_kb):
            koff = start + kj * kv_block
            kb = kt[:, :, koff:koff + kv_block]
            vb = vt[:, :, koff:koff + kv_block]
            kpos = koff + torch.arange(kv_block, device=q.device)
            logits = _attend_block(qb, kb, kpos, qpos, causal, window, softcap, scale)
            m_new = torch.maximum(m, logits.amax(-1))
            alpha = torch.exp(m - m_new)
            p_ = torch.exp(logits - m_new[..., None])
            l = l * alpha + p_.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum("bhqk,bhkd->bhqd", p_, vb.float())
            m = m_new
        out = acc / torch.clamp_min(l[..., None], 1e-30)
        blocks.append(out.to(q.dtype))
    return torch.cat(blocks, dim=2).transpose(1, 2)     # (B, S, H, hd)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     pos: int, window: int = 0, softcap: float = 0.0,
                     rotating: bool = False) -> torch.Tensor:
    """Single-token attention against a cache.

    q: (B, 1, H, hd); caches: (B, T, KV, hd); pos: the current absolute
    position.  ``rotating`` means the cache is a circular buffer of size
    T = window holding the last T tokens; only its unwritten prefix is
    masked while pos < T.  Grouped-query attention folds the group into q,
    so K and V are read once, never repeated.

    On a mesh each rank reads its own shard of a cache placed by
    ``partition.cache_spec``, with q split as the cache is: KV heads on
    ``model`` (each rank's query heads are those of its KV heads), or
    head_dim on ``model`` (each rank's partial q·K sums are reduced over
    the axis before the softmax), or neither.  A plain cache counts as
    replicated.  The result is split over the batch, and over the query
    heads where they divide the axis.
    """
    kw = dict(window=window, softcap=softcap, rotating=rotating)
    mesh = mesh_of(q, k_cache, v_cache)
    if mesh is None:
        return _decode_attention(PLAIN, q, k_cache, v_cache, pos, **kw)
    k_cache, v_cache = (c if isinstance(c, DTensor) else
                        DTensor.from_local(c, mesh, (Replicate(),) * mesh.ndim, run_check=False)
                        for c in (k_cache, v_cache))
    where = tuple(k_cache.placements)
    by_dim = any(p.is_shard(3) for p in where)
    out = on_local_shards(
        lambda axis, q, k, v: _decode_attention(axis, q, k, v, pos, by_dim=by_dim, **kw),
        (q, k_cache, v_cache), (where,) * 3, where)
    if by_dim:       # head_dim split: hand the heads over instead, where they divide
        out = out.redistribute(mesh, shards(mesh, out.shape, model=2))
    return out


def _decode_attention(axis: ModelAxis, q, k_cache, v_cache, pos: int, window: int,
                      softcap: float, rotating: bool, by_dim: bool = False) -> torch.Tensor:
    """:func:`decode_attention` on local tensors; ``by_dim``: head_dim is
    split over ``axis`` and the q·K sums are reduced over it."""
    b, _, h, hd = q.shape
    t = k_cache.shape[1]
    kvh = k_cache.shape[2]
    groups = h // kvh
    scale = 1.0 / math.sqrt(hd * axis.size if by_dim else hd)
    qg = q.reshape(b, 1, kvh, groups, hd)
    logits = torch.einsum("bokgd,btkd->bkgot", qg.float(), k_cache.float())
    if by_dim:
        logits = axis.sum(logits)
    logits = logits * scale
    if softcap > 0:
        logits = torch.tanh(logits / softcap) * softcap
    idx = torch.arange(t, device=q.device)
    if rotating:
        valid = idx < min(pos + 1, t)
    else:
        valid = idx <= pos
        if window > 0:
            valid &= idx > pos - window
    logits = torch.where(valid, logits, torch.full_like(logits, -1e30))
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgot,btkd->bokgd", w.to(v_cache.dtype), v_cache)
    return out.reshape(b, 1, h, hd)


# ---------------------------------------------------------------------------
# Attention block (self-attention, optionally with cache)
# ---------------------------------------------------------------------------

def attn_apply(p: Params, x: torch.Tensor, cfg: ArchConfig, *, causal: bool,
               local: bool, q_offset: int = 0, return_kv: bool = False):
    """Full-sequence attention (train / prefill path); with ``return_kv``
    also the rope'd K and V (B, S, KV, hd) it attended over, a prefill's
    cache contents (the JAX package's prefill projects them once too: XLA
    merges its two projections)."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(p, x, cfg)
    tables = rope_tables(q_offset + torch.arange(s, device=x.device), cfg.head_dim,
                         cfg.rope_theta)
    q = apply_rope(q, tables)
    k = apply_rope(k, tables)
    window = cfg.sliding_window if local else 0
    out = blockwise_attention(q, k, v, causal=causal, window=window,
                              softcap=cfg.logit_softcap)
    y = row_split(out.reshape(b, s, cfg.q_dim), p["wo"])
    return (y, k, v) if return_kv else y


def write_slot(cache: torch.Tensor, new: torch.Tensor, slot: int) -> None:
    """``cache[:, slot] = new[:, 0]`` in place, in the cache's dtype; on a
    mesh into this rank's shard of the cache, ``new`` placed as it is."""
    if isinstance(cache, DTensor):
        mesh = cache.device_mesh
        if not isinstance(new, DTensor):
            new = DTensor.from_local(new, mesh, (Replicate(),) * mesh.ndim, run_check=False)
        cache, new = cache.to_local(), new.redistribute(mesh, cache.placements).to_local()
    elif isinstance(new, DTensor):
        new = new.full_tensor()
    cache[:, slot] = new[:, 0].to(cache.dtype)


def attn_decode(p: Params, x: torch.Tensor, cfg: ArchConfig, cache: Dict[str, torch.Tensor],
                pos: int, *, local: bool,
                tables: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token attention; cache: {"k": (B,T,KV,hd), "v": ...}, updated in
    place and returned.  ``tables``: ``rope_tables`` of ``[pos]``, which a
    decode step computes once for all its layers."""
    b, s, _ = x.shape
    if s != 1:
        raise ValueError(f"attn_decode takes one token, got {s}")
    q, k, v = _project_qkv(p, x, cfg)
    if tables is None:
        tables = rope_tables(torch.tensor([pos], device=x.device), cfg.head_dim,
                             cfg.rope_theta)
    q = apply_rope(q, tables)
    k = apply_rope(k, tables)
    t = cache["k"].shape[1]
    rotating = local and t == cfg.sliding_window
    slot = (pos % t) if rotating else pos
    if not 0 <= slot < t:
        raise ValueError(f"position {pos} is outside a cache of {t}")
    write_slot(cache["k"], k, slot)
    write_slot(cache["v"], v, slot)
    window = cfg.sliding_window if local else 0
    out = decode_attention(q, cache["k"], cache["v"], pos, window=window,
                           softcap=cfg.logit_softcap, rotating=rotating)
    y = row_split(out.reshape(b, 1, cfg.q_dim), p["wo"])
    return y, cache


# ---------------------------------------------------------------------------
# Cross-attention (enc-dec): kv precomputed from encoder output
# ---------------------------------------------------------------------------

def cross_attn_specs(cfg: ArchConfig) -> Dict[str, ParamSpec]:
    return attn_specs(cfg)


def cross_attn_apply(p: Params, x: torch.Tensor, enc_k: torch.Tensor,
                     enc_v: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """x: (B, S, d); enc_k/enc_v: (B, T, KV, hd) — no mask (full cross)."""
    b, s, _ = x.shape
    q = split_heads(x @ p["wq"], cfg.num_heads, cfg.head_dim)
    out = blockwise_attention(q, enc_k, enc_v, causal=False, window=0)
    return row_split(out.reshape(b, s, cfg.q_dim), p["wo"])


def cross_kv(p: Params, enc_out: torch.Tensor,
             cfg: ArchConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    k = split_heads(enc_out @ p["wk"], cfg.num_kv_heads, cfg.head_dim)
    v = split_heads(enc_out @ p["wv"], cfg.num_kv_heads, cfg.head_dim)
    return k, v


def cross_attn_decode(p: Params, x: torch.Tensor, cfg: ArchConfig,
                      cache: Dict[str, torch.Tensor]) -> torch.Tensor:
    """One token's cross-attention against the static encoder K/V cache
    {"k": (B, T, KV, hd), "v": ...}, which it never writes."""
    b = x.shape[0]
    q = split_heads(x @ p["wq"], cfg.num_heads, cfg.head_dim)
    att = decode_attention(q, cache["k"], cache["v"], pos=cache["k"].shape[1] - 1)
    return row_split(att.reshape(b, 1, cfg.q_dim), p["wo"])


# ---------------------------------------------------------------------------
# MLP variants
# ---------------------------------------------------------------------------

def mlp_specs(cfg: ArchConfig) -> Dict[str, ParamSpec]:
    d, f = cfg.d_model, cfg.d_ff
    if cfg.mlp_type in ("swiglu", "geglu"):
        return {
            "wg": ParamSpec((d, f), ("embed", "mlp"), init="scaled_normal"),
            "wu": ParamSpec((d, f), ("embed", "mlp"), init="scaled_normal"),
            "wd": ParamSpec((f, d), ("mlp", "embed"), init="scaled_normal"),
        }
    return {
        "wi": ParamSpec((d, f), ("embed", "mlp"), init="scaled_normal"),
        "wd": ParamSpec((f, d), ("mlp", "embed"), init="scaled_normal"),
    }


_WIDE = (torch.float32, torch.float64)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` as the JAX package's program computes it: ``x * (1 /
    (1 + exp(-x)))``, every op in ``x.dtype``, so a bfloat16 operand is
    rounded after each op (``F.silu`` computes in float32 and rounds once:
    it differs on 74,726 of 200,000 bfloat16 draws from N(0, 16)).  In
    float32 and float64 it is ``F.silu``: there the two differ only by
    float32 rounding, which every float32 tolerance covers, and ``F.silu``
    is one launch on a card where the lowering is five."""
    if x.dtype in _WIDE:
        return F.silu(x)
    return x * torch.reciprocal(1 + torch.exp(-x))      # reciprocal(y) is 1 / y rounded once


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` (the tanh approximation, its default) as the JAX
    package's program computes it: ``x * (0.5 * (1 + tanh(c * (x + k ·
    x³))))`` with c = sqrt(2/π) and k = 0.044715 cast to ``x.dtype`` first
    and every op in ``x.dtype``.  In float32 and float64 it is
    ``F.gelu(approximate="tanh")``, for the reasons :func:`silu` gives (one
    launch on a card where the lowering is nine)."""
    if x.dtype in _WIDE:
        return F.gelu(x, approximate="tanh")
    c, k = _rounded(math.sqrt(2 / math.pi), x.dtype), _rounded(0.044715, x.dtype)
    return x * (0.5 * (1 + torch.tanh(c * (x + k * (x * (x * x))))))


@functools.lru_cache(maxsize=None)
def _rounded(v: float, dtype: torch.dtype) -> float:
    """``v`` rounded to ``dtype``, as JAX casts a constant to the operand's dtype."""
    return float(torch.tensor(v, dtype=dtype))


def mlp_apply(p: Params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """GELU is the tanh approximation, ``jax.nn.gelu``'s default; both
    activations round as the JAX package's do (:func:`silu`,
    :func:`gelu_tanh`).  The down projection is ``partition.row_split``'s
    (its rows split on a mesh)."""
    if cfg.mlp_type == "swiglu":
        return row_split(silu(x @ p["wg"]) * (x @ p["wu"]), p["wd"])
    if cfg.mlp_type == "geglu":
        return row_split(gelu_tanh(x @ p["wg"]) * (x @ p["wu"]), p["wd"])
    if cfg.mlp_type == "squared_relu":
        h = F.relu(x @ p["wi"])
        return row_split(h * h, p["wd"])
    if cfg.mlp_type == "gelu":
        return row_split(gelu_tanh(x @ p["wi"]), p["wd"])
    raise ValueError(f"unknown mlp_type {cfg.mlp_type}")


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------

def embed_specs(cfg: ArchConfig) -> Dict[str, ParamSpec]:
    v, d = cfg.padded_vocab, cfg.d_model
    out = {"embedding": ParamSpec((v, d), ("vocab", "embed"), init="normal")}
    if not cfg.tie_embeddings:
        out["head"] = ParamSpec((d, v), ("embed", "vocab"), init="scaled_normal")
    return out


def embed_apply(p: Params, tokens: torch.Tensor) -> torch.Tensor:
    """The token rows of the embedding table.  On a mesh whose ``model``
    axis splits the vocabulary, each rank looks up the tokens of its own
    rows (zero for the others) and the rows are summed over the axis, as
    GSPMD partitions the JAX package's lookup; otherwise over the table
    gathered.  The result is split over the batch alone."""
    table = p["embedding"]
    mesh = mesh_of(table)
    if mesh is None:
        return F.embedding(tokens, table)
    vocab = table.shape[0]
    tp = shards(mesh, tokens.shape)
    rows = shards(mesh, table.shape, batch=None, model=0)
    if rows == (Replicate(),) * mesh.ndim:
        # DTensor's rule for a lookup in a vocab-sharded table fails: gather the table
        return F.embedding(tokens, gathered(table))

    def look(axis, tok, tab):
        v0, v1 = axis.span(vocab)
        inside = (tok >= v0) & (tok < v1)
        out = F.embedding(torch.where(inside, tok - v0, torch.zeros_like(tok)), tab)
        return out * inside[..., None].to(out.dtype)

    partial = tuple(Partial() if r.is_shard(0) else t for r, t in zip(rows, tp))
    out = on_local_shards(look, (tokens, table), (tp, rows), partial)
    return out.redistribute(mesh, tp)


def token_nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """-log softmax(logits)[target] of each position: logits (B, S, V)
    float32, targets (B, S) integers.  On a mesh whose ``model`` axis splits
    the vocabulary each rank takes the log-sum-exp and the target's logit
    of its own columns, and both are combined over the axis (the JAX
    package's loss is reduced so too): the logits are never gathered."""
    mesh = mesh_of(logits)
    if mesh is None:
        lse = torch.logsumexp(logits, dim=-1)
        return lse - torch.gather(logits, -1, targets[..., None].long())[..., 0]
    vocab = logits.shape[-1]
    rows = shards(mesh, targets.shape)
    cols = shards(mesh, logits.shape, model=2)

    def nll(axis, lg, tgt):
        if lg.shape[-1] == vocab:
            return torch.logsumexp(lg, dim=-1) - torch.gather(lg, -1, tgt[..., None].long())[..., 0]
        v0, v1 = axis.span(vocab)
        part = torch.logsumexp(lg, dim=-1)[..., None]
        lse = torch.logsumexp(axis.gather(part, part.ndim - 1), dim=-1)
        inside = (tgt >= v0) & (tgt < v1)
        gold = torch.gather(lg, -1, torch.where(inside, tgt - v0, torch.zeros_like(tgt))[..., None]
                            .long())[..., 0]
        return lse - axis.sum(gold * inside.to(gold.dtype))

    return on_local_shards(nll, (logits, targets), (cols, rows), rows)


def head_apply(p: Params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Logits over ``padded_vocab``, unmasked, as in the JAX package."""
    if cfg.tie_embeddings:
        return x @ p["embedding"].T
    return x @ p["head"]

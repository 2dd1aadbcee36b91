"""Decoder LM for every layer kind: the dense, vlm, MoE, SSM and hybrid
families.

The port of the JAX package's ``models/lm.py``.  :class:`LM` is an
``nn.Module`` holding its parameters on one device, one block per layer in
an ``nn.ModuleList``, and Zamba2's one shared attention block under
``shared_attn``.  The block kinds: ``attn_mlp`` (mistral-nemo-12b,
mistral-large-123b, nemotron-4-340b, gemma3-27b with local/global
attention, internvl2-26b with the ``vit_stub`` projector), ``attn_moe``
(mixtral-8x22b, phi3.5-moe-42b-a6.6b; ``models/moe.py``), ``mamba``
(zamba2-1.2b, with the shared attention block before every
``shared_attn_every``-th layer) and ``mlstm``/``slstm`` (xlstm-125m;
``models/ssm.py``).  The JAX package stacks the parameters of each slot of
the layer period and scans over periods; the port runs the same layers in
order, and ``repro_torch.convert.lm_params_from_jax`` unstacks the JAX
package's tree (``slots/s{i}[p]`` is layer ``p·plen + i``, ``rem/r{j}``
the tail).  ``launch.partition.constrain`` is called where the JAX
package calls it (the batch axis at every layer, logits on ``vocab``, the
``seq_sp`` rule at each period's end); it is the identity without a mesh
and for plain tensors, and redistributes DTensors on one.

Paths:

* ``forward_train`` and ``loss_fn`` — the full-sequence forward and the
  causal LM loss, differentiable: each block runs under
  ``torch.utils.checkpoint`` when ``cfg.remat`` (the JAX package's
  ``jax.checkpoint``), which changes memory, never numbers;
* ``prefill`` — full-sequence forward that also emits per-layer decode
  caches (attention K/V, the recurrent blocks' final states);
* ``decode_step`` — one token over every layer with explicit caches, which
  it updates in place: the attention caches are written at ``pos``, a
  recurrent block's state is replaced in its layer's entry.

Each application of Zamba2's shared block keeps its own KV cache, under
``"shared"`` in the entry of the layer it precedes.  The encoder-decoder
is :class:`repro_torch.models.encdec.EncDecLM`; ``LM`` refuses its config.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from repro_torch._device import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.launch.partition import (cache_placements, constrain, current_mesh,
                                          mesh_of, place_local)
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.models.params import ParamSpec, cast_specs, initialize

__all__ = ["LM", "Slot", "period_layout", "layer_slots", "block_specs", "shared_attn_specs",
           "remat_apply", "kv_cache", "placed_zeros"]

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# Period layout
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Slot:
    kind: str          # attn_mlp | attn_moe | mamba | mlstm | slstm
    local: bool        # attention locality (static per slot)
    shared_attn: bool  # zamba: run the shared attention block before this slot


def period_layout(cfg: ArchConfig) -> Tuple[List[Slot], int, List[Slot]]:
    """Returns (period_slots, n_periods, remainder_slots)."""
    kinds = cfg.layer_kinds()
    nl = cfg.num_layers
    if cfg.family == "ssm" and cfg.slstm_every:
        plen = cfg.slstm_every
    elif cfg.family == "hybrid" and cfg.shared_attn_every:
        plen = cfg.shared_attn_every
    elif cfg.attn_pattern == "local_global":
        plen = cfg.local_global_ratio + 1
    else:
        plen = 1
    plen = min(plen, nl)

    def slot_for(i: int) -> Slot:
        return Slot(
            kind=kinds[i],
            local=cfg.attn_layer_is_local(i),
            shared_attn=(cfg.shared_attn_every > 0
                         and i % cfg.shared_attn_every == 0),
        )

    n_periods = nl // plen
    period = [slot_for(i) for i in range(plen)]
    remainder = [slot_for(n_periods * plen + j)
                 for j in range(nl - n_periods * plen)]
    return period, n_periods, remainder


def layer_slots(cfg: ArchConfig) -> List[Slot]:
    """The slot of each of the ``num_layers`` layers, in order."""
    period, n_periods, remainder = period_layout(cfg)
    plen = len(period)
    return [period[l % plen] if l < n_periods * plen else remainder[l - n_periods * plen]
            for l in range(cfg.num_layers)]


# ---------------------------------------------------------------------------
# Per-block specs / apply
# ---------------------------------------------------------------------------

def block_specs(cfg: ArchConfig, slot: Slot) -> Dict[str, Any]:
    s: Dict[str, Any] = {"norm1": L.norm_spec(cfg)}
    if slot.kind in ("attn_mlp", "attn_moe"):
        s["attn"] = L.attn_specs(cfg)
        s["norm2"] = L.norm_spec(cfg)
        if slot.kind == "attn_mlp":
            s["mlp"] = L.mlp_specs(cfg)
        else:
            s["moe"] = MOE.moe_specs(cfg)
    elif slot.kind == "mamba":
        # Zamba2-style: mamba layers have no per-layer MLP; the d_ff MLP
        # belongs to the shared attention block.
        s["mamba"] = SSM.mamba_specs(cfg)
    elif slot.kind == "mlstm":
        s["mlstm"] = SSM.mlstm_specs(cfg)
    elif slot.kind == "slstm":
        s["slstm"] = SSM.slstm_specs(cfg)
    else:
        raise ValueError(slot.kind)
    return s


def shared_attn_specs(cfg: ArchConfig) -> Dict[str, Any]:
    """Zamba2's one shared attention block (and its MLP when d_ff)."""
    out = {"norm": L.norm_spec(cfg), "attn": L.attn_specs(cfg)}
    if cfg.d_ff:
        out["norm2"] = L.norm_spec(cfg)
        out["mlp"] = L.mlp_specs(cfg)
    return out


def _ffn(p, x: torch.Tensor, cfg: ArchConfig, slot: Slot) -> torch.Tensor:
    """The feed-forward half of an attention block: MLP or MoE."""
    h2 = L.apply_norm(p["norm2"], x)
    if slot.kind == "attn_mlp":
        return L.mlp_apply(p["mlp"], h2, cfg)
    return MOE.moe_apply(p["moe"], h2, cfg)


def _shared_mlp(shared_p, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    if not cfg.d_ff:
        return x
    return x + L.mlp_apply(shared_p["mlp"], L.apply_norm(shared_p["norm2"], x), cfg)


def block_apply(p, x: torch.Tensor, cfg: ArchConfig, slot: Slot,
                shared_p=None) -> torch.Tensor:
    """Full-sequence (train) path for one block, after the shared attention
    block where the slot has one.  On a mesh its input is first split over
    the batch alone: a period's end may leave the sequence split over
    ``model`` (``seq_shard_train``), which the block's matmuls cannot take
    on every torch release; under remat the saved input stays split."""
    x = constrain(x, ("batch", None, None))
    if slot.shared_attn and shared_p is not None:
        x = x + L.attn_apply(shared_p["attn"], L.apply_norm(shared_p["norm"], x), cfg,
                             causal=True, local=False)
        x = _shared_mlp(shared_p, x, cfg)
    h = L.apply_norm(p["norm1"], x)
    if slot.kind in ("attn_mlp", "attn_moe"):
        x = x + L.attn_apply(p["attn"], h, cfg, causal=True, local=slot.local)
        return x + _ffn(p, x, cfg, slot)
    if slot.kind == "mamba":
        return x + SSM.mamba_apply(p["mamba"], h, cfg)
    if slot.kind == "mlstm":
        return x + SSM.mlstm_apply(p["mlstm"], h, cfg)
    return x + SSM.slstm_apply(p["slstm"], h, cfg)


def remat_apply(fn, remat: bool, *args):
    """``fn(*args)``, under ``torch.utils.checkpoint`` when ``remat`` and
    grad is on: the block's activations are recomputed in the backward
    instead of kept (the JAX package's ``jax.checkpoint``)."""
    if remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def kv_cache(k: torch.Tensor, v: torch.Tensor, dtype: torch.dtype, window: Optional[int] = None,
             max_seq: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """The decode cache {"k", "v"} of one attention application from the
    K and V (B, S, KV, hd) it attended over, in ``dtype``: full length,
    padded to ``max_seq`` (> S), or, for a window shorter than S, the last
    ``window`` keys in rotating layout (slot = pos % window).  On a mesh
    each rank keeps its shard, placed by ``partition.cache_spec``."""
    s = k.shape[1]

    def layout(t: torch.Tensor) -> torch.Tensor:
        if window is not None and window < s:
            t = torch.roll(t[:, -window:], s % window, dims=1)
        elif max_seq is not None and max_seq > s:
            t = torch.nn.functional.pad(t, (0, 0, 0, 0, 0, max_seq - s))
        return t.to(dtype).contiguous()

    mesh = mesh_of(k, v)
    if mesh is None:
        return {"k": layout(k), "v": layout(v)}
    t = window if window is not None and window < s else max(s, max_seq or s)
    where = cache_placements(mesh, (k.shape[0], t, *k.shape[2:]))
    return {name: DTensor.from_local(layout(x.redistribute(mesh, where).to_local()), mesh, where,
                                     run_check=False)
            for name, x in (("k", k), ("v", v))}


def placed_zeros(shape, dtype: torch.dtype, device) -> torch.Tensor:
    """Zeros of ``shape``; under an ambient mesh a DTensor placed by
    ``partition.cache_spec``, each rank allocating its shard alone."""
    mesh = current_mesh()
    if mesh is None:
        return torch.zeros(shape, dtype=dtype, device=device)
    where = cache_placements(mesh, shape)
    local = list(shape)
    for i, p in enumerate(where):
        if p.is_shard():
            local[p.dim] //= mesh.size(i)
    return DTensor.from_local(torch.zeros(local, dtype=dtype, device=device), mesh, where,
                              run_check=False)


def placed_state(state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A recurrent block's decode state, under an ambient mesh each tensor
    placed by ``partition.cache_spec``."""
    mesh = current_mesh()
    if mesh is None:
        return state
    return {k: place_local(t, mesh, cache_placements(mesh, t.shape)) for k, t in state.items()}


def _module(tree) -> nn.Module:
    """A dict of tensors as an ``nn.ParameterDict``; a dict of such dicts as
    an ``nn.ModuleDict``."""
    if all(isinstance(v, torch.Tensor) for v in tree.values()):
        return nn.ParameterDict({k: nn.Parameter(v) for k, v in tree.items()})
    return nn.ModuleDict({k: _module(v) for k, v in tree.items()})


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------

class LM(nn.Module):
    """The decoder LM of ``cfg`` with its parameters on ``device``.

    ``device`` is the card by default and raises where there is none; pass
    ``"cpu"`` for the CPU, or ``"meta"`` for shapes and counts without
    allocation.  Parameters are drawn by :func:`~repro_torch.models.params.
    initialize` from ``generator`` (a ``torch.Generator`` on ``device``;
    seed 0 when None), in ``cfg.dtype`` with norms in float32.
    """

    def __init__(self, cfg: ArchConfig, device: str | torch.device = "cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.is_encdec:
            raise ValueError(f"{cfg.name} is an encoder-decoder: build it with "
                             "repro_torch.models.encdec.EncDecLM (or build_model)")
        dev = torch.device(device)
        if dev.type != "meta":
            dev = resolve_device(dev)
        self.cfg = cfg
        self.slots = layer_slots(cfg)
        if generator is None and dev.type != "meta":
            generator = torch.Generator(device=dev).manual_seed(0)
        params = initialize(self.specs(), generator, dev)
        self.embed = _module(params["embed"])
        self.final_norm = _module(params["final_norm"])
        self.layers = nn.ModuleList(_module(p) for p in params["layers"])
        self.shared_attn = _module(params["shared_attn"]) if "shared_attn" in params else None
        if "projector" in params:
            self.projector = _module(params["projector"])

    @property
    def device(self) -> torch.device:
        return self.embed["embedding"].device

    # -- parameter specs -----------------------------------------------------
    def specs(self) -> Params:
        """The spec tree: one block per layer under ``"layers"`` (the JAX
        package stacks them per slot of the period; the leaves and their
        count are the same)."""
        cfg = self.cfg
        out: Params = {"embed": L.embed_specs(cfg), "final_norm": L.norm_spec(cfg),
                       "layers": [block_specs(cfg, slot) for slot in layer_slots(cfg)]}
        if cfg.shared_attn_every:
            out["shared_attn"] = shared_attn_specs(cfg)
        if cfg.frontend == "vit_stub":
            out["projector"] = {
                "w": ParamSpec((cfg.frontend_dim, cfg.d_model),
                               ("unsharded", "embed"), init="scaled_normal")}
        return cast_specs(out, getattr(torch, cfg.dtype))

    # -- embedding of (tokens [, image embeds]) ------------------------------
    def _embed_inputs(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        x = L.embed_apply(self.embed, batch["tokens"])
        if self.cfg.frontend == "vit_stub":
            img = batch["image_embeds"].to(x.dtype) @ self.projector["w"]
            x = torch.cat([img, x], dim=1)
        return x

    # -- training forward -----------------------------------------------------
    def forward_train(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Returns logits (B, S_total, vocab_padded), float32."""
        cfg = self.cfg
        period, n_periods, _ = period_layout(cfg)
        x = constrain(self._embed_inputs(batch), ("batch", None, None))
        sp_rules = {"seq_sp": "model" if cfg.seq_shard_train else None}
        for l, (slot, p) in enumerate(zip(self.slots, self.layers)):
            x = remat_apply(block_apply, cfg.remat, p, x, cfg, slot, self.shared_attn)
            if l < n_periods * len(period) and (l + 1) % len(period) == 0:
                # a period's end (the JAX package's scan carry): batch over
                # (pod, data), optionally the sequence over model
                x = constrain(x, ("batch", "seq_sp", None), sp_rules)
        x = L.apply_norm(self.final_norm, constrain(x, ("batch", None, None)))
        logits = L.head_apply(self.embed, x, cfg).float()
        return constrain(logits, ("batch", None, "vocab"))

    def loss_fn(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Causal LM loss on the text tokens (image prefix excluded)."""
        logits = self.forward_train(batch)
        if self.cfg.frontend == "vit_stub":
            logits = logits[:, batch["image_embeds"].shape[1]:]
        tgt = batch["labels"][:, 1:]
        lg = logits[:, :-1]
        return L.token_nll(lg, tgt).mean()

    # -- caches ---------------------------------------------------------------
    def init_cache(self, batch: int, max_seq: int, dtype: Optional[torch.dtype] = None
                   ) -> List[Dict[str, Dict[str, torch.Tensor]]]:
        """Per-layer decode state: attention caches sized full or window (in
        ``dtype``, the model's by default), recurrent states in float32.
        Under an ambient mesh (``with mesh:``) each is a DTensor placed by
        ``launch.sharding.cache_sharding_rules``."""
        cfg = self.cfg
        dtype = dtype or self.cache_dtype()
        dev = self.device
        caches = []
        for slot in self.slots:
            entry: Dict[str, Dict[str, torch.Tensor]] = {}
            if slot.shared_attn and cfg.shared_attn_every:
                entry["shared"] = self._attn_cache(batch, max_seq, False, dtype)
            if slot.kind in ("attn_mlp", "attn_moe"):
                entry["attn"] = self._attn_cache(batch, max_seq, slot.local, dtype)
            elif slot.kind == "mamba":
                entry["mamba"] = placed_state(SSM.mamba_init_state(cfg, batch, device=dev))
            elif slot.kind == "mlstm":
                entry["mlstm"] = placed_state(SSM.mlstm_init_state(cfg, batch, device=dev))
            elif slot.kind == "slstm":
                entry["slstm"] = placed_state(SSM.slstm_init_state(cfg, batch, device=dev))
            caches.append(entry)
        return caches

    def cache_dtype(self) -> torch.dtype:
        return getattr(torch, self.cfg.dtype)

    def _attn_cache(self, batch: int, max_seq: int, local: bool, dtype):
        cfg = self.cfg
        t = min(cfg.sliding_window, max_seq) if local else max_seq
        shape = (batch, t, cfg.num_kv_heads, cfg.head_dim)
        return {"k": placed_zeros(shape, dtype, self.device),
                "v": placed_zeros(shape, dtype, self.device)}

    # -- decode ---------------------------------------------------------------
    @torch.no_grad()
    def decode_step(self, token: torch.Tensor, caches: List, pos: int
                    ) -> Tuple[torch.Tensor, List]:
        """token: (B, 1) integers; pos: the current absolute position.

        Returns (logits (B, vocab_padded) float32, caches), the caches
        updated in place.
        """
        cfg = self.cfg
        x = constrain(L.embed_apply(self.embed, token), ("batch", None, None))
        tables = L.rope_tables(torch.tensor([pos], device=x.device), cfg.head_dim,
                               cfg.rope_theta)
        shared_p = self.shared_attn
        for slot, p, cache in zip(self.slots, self.layers, caches):
            x = constrain(x, ("batch", None, None))
            if slot.shared_attn and shared_p is not None:
                y, _ = L.attn_decode(shared_p["attn"], L.apply_norm(shared_p["norm"], x), cfg,
                                     cache["shared"], pos, local=False, tables=tables)
                x = _shared_mlp(shared_p, x + y, cfg)
            h = L.apply_norm(p["norm1"], x)
            if slot.kind in ("attn_mlp", "attn_moe"):
                y, _ = L.attn_decode(p["attn"], h, cfg, cache["attn"], pos, local=slot.local,
                                     tables=tables)
                x = x + y
                x = x + _ffn(p, x, cfg, slot)
            else:
                step = {"mamba": SSM.mamba_decode, "mlstm": SSM.mlstm_decode,
                        "slstm": SSM.slstm_decode}[slot.kind]
                y, cache[slot.kind] = step(p[slot.kind], h, cfg, cache[slot.kind])
                x = x + y
        x = L.apply_norm(self.final_norm, x)
        logits = L.head_apply(self.embed, x, cfg).float()
        return logits[:, 0], caches

    # -- prefill ---------------------------------------------------------------
    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, image_embeds: Optional[torch.Tensor] = None,
                max_seq: Optional[int] = None) -> Tuple[torch.Tensor, List]:
        """Full forward emitting final-position logits + per-layer caches.

        Attention caches are written full-length (local layers keep the last
        ``window`` keys in rotating layout); recurrent layers return their
        final states.  ``max_seq``: allocate global caches at this length
        (> S) so decode can continue appending; default = exactly S.  On a
        mesh every cache and state is a DTensor placed by
        ``launch.sharding.cache_sharding_rules``.
        """
        cfg = self.cfg
        batch = {"tokens": tokens}
        if image_embeds is not None:
            batch["image_embeds"] = image_embeds
        x = constrain(self._embed_inputs(batch), ("batch", None, None))
        dt = self.cache_dtype()
        shared_p = self.shared_attn
        caches: List[Any] = []
        for slot, p in zip(self.slots, self.layers):
            x = constrain(x, ("batch", None, None))
            entry: Dict[str, Any] = {}
            if slot.shared_attn and shared_p is not None:
                h = L.apply_norm(shared_p["norm"], x)
                y, k, v = L.attn_apply(shared_p["attn"], h, cfg, causal=True, local=False,
                                       return_kv=True)
                x = x + y
                entry["shared"] = kv_cache(k, v, dt, max_seq=max_seq)
                x = _shared_mlp(shared_p, x, cfg)
            h = L.apply_norm(p["norm1"], x)
            if slot.kind in ("attn_mlp", "attn_moe"):
                y, k, v = L.attn_apply(p["attn"], h, cfg, causal=True, local=slot.local,
                                       return_kv=True)
                x = x + y
                entry["attn"] = kv_cache(k, v, dt, window=cfg.sliding_window if slot.local
                                         else None, max_seq=max_seq)
                x = x + _ffn(p, x, cfg, slot)
            else:
                apply = {"mamba": SSM.mamba_apply, "mlstm": SSM.mlstm_apply,
                         "slstm": SSM.slstm_apply}[slot.kind]
                y, entry[slot.kind] = apply(p[slot.kind], h, cfg, return_state=True)
                x = x + y
            caches.append(entry)
        x = L.apply_norm(self.final_norm, x)
        logits = L.head_apply(self.embed, x[:, -1:], cfg)
        return logits[:, 0].float(), caches

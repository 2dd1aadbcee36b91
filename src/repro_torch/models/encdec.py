"""Encoder–decoder LM (Seamless-M4T-style text backbone).

The port of the JAX package's ``models/encdec.py``.  The speech/audio
frontend is a stub: ``frames`` are precomputed frame embeddings
(B, T_enc, frontend_dim) that the linear ``frontend_proj`` maps to
d_model.  Encoder = bidirectional self-attention + MLP; decoder = causal
self-attention + cross-attention + MLP; every self-attention keeps its
rope, cross-attention has none.  The JAX package stacks each stack's layers
on one leading axis and scans over them; the port holds one block per layer
in ``enc`` and ``dec`` (``nn.ModuleList``), and
``repro_torch.convert.lm_params_from_jax`` unstacks the tree (``enc/<leaf>[i]``
is ``enc.<i>.<leaf>``, ``dec/<leaf>[i]`` is ``dec.<i>.<leaf>``).

Serving: ``prefill`` encodes the frames and runs the decoder over the
prompt, returning the last position's logits and per decoder layer the
cache ``{"self": {"k", "v"}, "cross": {"k", "v"}}``; ``decode_step``
writes the self-attention cache at ``pos`` in place, as ``LM.decode_step``
does, and reads the cross cache, which it never writes.  The JAX package's
serving entry point refuses this arch, and so does the port's
(``launch/serve.py``): a caller drives these methods.

Training: ``forward_train`` and ``loss_fn`` are differentiable, each
encoder and decoder block under ``torch.utils.checkpoint`` when
``cfg.remat`` (the JAX package's ``jax.checkpoint`` of each stack's scan
body).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn

from repro_torch._device import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.launch.partition import constrain
from repro_torch.models import layers as L
from repro_torch.models.lm import _module, kv_cache, placed_zeros, remat_apply
from repro_torch.models.params import ParamSpec, cast_specs, initialize

__all__ = ["EncDecLM", "enc_block_specs", "dec_block_specs"]

Params = Dict[str, Any]


def enc_block_specs(cfg: ArchConfig) -> Params:
    return {"norm1": L.norm_spec(cfg), "attn": L.attn_specs(cfg),
            "norm2": L.norm_spec(cfg), "mlp": L.mlp_specs(cfg)}


def dec_block_specs(cfg: ArchConfig) -> Params:
    return {"norm1": L.norm_spec(cfg), "self_attn": L.attn_specs(cfg),
            "norm_x": L.norm_spec(cfg), "cross_attn": L.cross_attn_specs(cfg),
            "norm2": L.norm_spec(cfg), "mlp": L.mlp_specs(cfg)}


def _enc_block(p, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    x = x + L.attn_apply(p["attn"], L.apply_norm(p["norm1"], x), cfg, causal=False,
                         local=False)
    return x + L.mlp_apply(p["mlp"], L.apply_norm(p["norm2"], x), cfg)


def _dec_block(p, x: torch.Tensor, enc_out: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """One decoder block of the training forward."""
    x = x + L.attn_apply(p["self_attn"], L.apply_norm(p["norm1"], x), cfg, causal=True,
                         local=False)
    k, v = L.cross_kv(p["cross_attn"], enc_out, cfg)
    x = x + L.cross_attn_apply(p["cross_attn"], L.apply_norm(p["norm_x"], x), k, v, cfg)
    return x + L.mlp_apply(p["mlp"], L.apply_norm(p["norm2"], x), cfg)


class EncDecLM(nn.Module):
    """The encoder-decoder of ``cfg`` with its parameters on ``device``.

    ``device`` is the card by default and raises where there is none; pass
    ``"cpu"`` for the CPU, or ``"meta"`` for shapes and counts without
    allocation.  Parameters are drawn from ``generator`` (seed 0 when None)
    in ``cfg.dtype`` with norms in float32, as :class:`~repro_torch.models.
    lm.LM`'s are.
    """

    def __init__(self, cfg: ArchConfig, device: str | torch.device = "cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if not cfg.is_encdec:
            raise ValueError(f"{cfg.name} has no encoder: build it with LM")
        dev = torch.device(device)
        if dev.type != "meta":
            dev = resolve_device(dev)
        self.cfg = cfg
        if generator is None and dev.type != "meta":
            generator = torch.Generator(device=dev).manual_seed(0)
        params = initialize(self.specs(), generator, dev)
        self.frontend_proj = nn.Parameter(params["frontend_proj"])
        self.embed = _module(params["embed"])
        self.enc = nn.ModuleList(_module(p) for p in params["enc"])
        self.enc_norm = _module(params["enc_norm"])
        self.dec = nn.ModuleList(_module(p) for p in params["dec"])
        self.dec_norm = _module(params["dec_norm"])

    @property
    def device(self) -> torch.device:
        return self.embed["embedding"].device

    def cache_dtype(self) -> torch.dtype:
        return getattr(torch, self.cfg.dtype)

    # -- parameter specs -----------------------------------------------------
    def specs(self) -> Params:
        """The spec tree: one block per layer under ``"enc"`` and ``"dec"``
        (the JAX package stacks each; the leaves and their count are the
        same)."""
        cfg = self.cfg
        out = {
            "frontend_proj": ParamSpec((cfg.frontend_dim or cfg.d_model, cfg.d_model),
                                       ("unsharded", "embed"), init="scaled_normal"),
            "embed": L.embed_specs(cfg),
            "enc": [enc_block_specs(cfg) for _ in range(cfg.enc_layers)],
            "enc_norm": L.norm_spec(cfg),
            "dec": [dec_block_specs(cfg) for _ in range(cfg.num_layers)],
            "dec_norm": L.norm_spec(cfg),
        }
        return cast_specs(out, getattr(torch, cfg.dtype))

    # -- encoder ---------------------------------------------------------------
    def encode(self, frames: torch.Tensor) -> torch.Tensor:
        """frames (B, T, frontend_dim), cast to the model dtype first ->
        the encoder's output (B, T, d_model)."""
        cfg = self.cfg
        x = frames.to(self.cache_dtype()) @ self.frontend_proj
        for p in self.enc:
            x = constrain(remat_apply(_enc_block, cfg.remat, p, x, cfg), ("batch", None, None))
        return L.apply_norm(self.enc_norm, x)

    # -- decoder (training) ----------------------------------------------------
    def forward_train(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """batch: ``frames`` and ``tokens``.  Returns logits (B, S,
        vocab_padded), float32."""
        cfg = self.cfg
        enc_out = self.encode(batch["frames"])
        x = L.embed_apply(self.embed, batch["tokens"])
        for p in self.dec:
            x = constrain(remat_apply(_dec_block, cfg.remat, p, x, enc_out, cfg),
                          ("batch", None, None))
        x = L.apply_norm(self.dec_norm, x)
        return constrain(L.head_apply(self.embed, x, cfg).float(), ("batch", None, "vocab"))

    def loss_fn(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Causal LM loss of the decoder's tokens."""
        logits = self.forward_train(batch)
        tgt = batch["labels"][:, 1:]
        lg = logits[:, :-1]
        return L.token_nll(lg, tgt).mean()

    # -- serving ---------------------------------------------------------------
    def init_cache(self, batch: int, max_seq: int, enc_len: int,
                   dtype: Optional[torch.dtype] = None) -> List[Dict[str, Dict[str, torch.Tensor]]]:
        """Per decoder layer, zeroed self-attention K/V of ``max_seq`` and
        cross K/V of ``enc_len`` positions, in ``dtype`` (the model's by
        default); under an ambient mesh DTensors placed by
        ``launch.sharding.cache_sharding_rules``."""
        cfg = self.cfg
        dtype = dtype or self.cache_dtype()

        def zeros(t: int) -> Dict[str, torch.Tensor]:
            shape = (batch, t, cfg.num_kv_heads, cfg.head_dim)
            return {"k": placed_zeros(shape, dtype, self.device),
                    "v": placed_zeros(shape, dtype, self.device)}

        return [{"self": zeros(max_seq), "cross": zeros(enc_len)} for _ in range(cfg.num_layers)]

    @torch.no_grad()
    def prefill(self, frames: torch.Tensor, tokens: torch.Tensor,
                max_seq: Optional[int] = None) -> Tuple[torch.Tensor, List]:
        """Encode + decoder prefill; returns last-token logits (B,
        vocab_padded) float32 and the caches, the self K/V padded to
        ``max_seq`` (> S) so that decode can continue appending; on a mesh
        DTensors placed by ``launch.sharding.cache_sharding_rules``."""
        cfg = self.cfg
        dt = self.cache_dtype()
        enc_out = self.encode(frames)
        x = L.embed_apply(self.embed, tokens)
        caches: List[Any] = []
        for p in self.dec:
            x = constrain(x, ("batch", None, None))
            h = L.apply_norm(p["norm1"], x)
            y, k_self, v_self = L.attn_apply(p["self_attn"], h, cfg, causal=True, local=False,
                                             return_kv=True)
            x = x + y
            k_x, v_x = L.cross_kv(p["cross_attn"], enc_out, cfg)
            x = x + L.cross_attn_apply(p["cross_attn"], L.apply_norm(p["norm_x"], x), k_x, v_x,
                                       cfg)
            x = x + L.mlp_apply(p["mlp"], L.apply_norm(p["norm2"], x), cfg)
            caches.append({"self": kv_cache(k_self, v_self, dt, max_seq=max_seq),
                           "cross": kv_cache(k_x, v_x, dt)})
        x = L.apply_norm(self.dec_norm, x)
        logits = L.head_apply(self.embed, x[:, -1:], cfg)
        return logits[:, 0].float(), caches

    @torch.no_grad()
    def decode_step(self, token: torch.Tensor, caches: List, pos: int
                    ) -> Tuple[torch.Tensor, List]:
        """token: (B, 1) integers; pos: the current absolute position.

        Returns (logits (B, vocab_padded) float32, caches), the self caches
        updated in place.
        """
        cfg = self.cfg
        x = L.embed_apply(self.embed, token)
        tables = L.rope_tables(torch.tensor([pos], device=x.device), cfg.head_dim,
                               cfg.rope_theta)
        for p, cache in zip(self.dec, caches):
            x = constrain(x, ("batch", None, None))
            y, _ = L.attn_decode(p["self_attn"], L.apply_norm(p["norm1"], x), cfg,
                                 cache["self"], pos, local=False, tables=tables)
            x = x + y
            x = x + L.cross_attn_decode(p["cross_attn"], L.apply_norm(p["norm_x"], x), cfg,
                                        cache["cross"])
            x = x + L.mlp_apply(p["mlp"], L.apply_norm(p["norm2"], x), cfg)
        x = L.apply_norm(self.dec_norm, x)
        logits = L.head_apply(self.embed, x, cfg).float()
        return logits[:, 0], caches

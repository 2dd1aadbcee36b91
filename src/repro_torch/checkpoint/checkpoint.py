"""Checkpointing of a model's parameters and an optimizer's state.

The port of the JAX package's ``checkpoint/checkpoint.py``, with its
on-disk layout: one directory per step, ``step_%08d``, written as
``step_%08d.tmp`` and renamed when complete, holding

* ``manifest.json`` — ``step``, ``extras`` (the data pipeline's cursor)
  and ``arrays``: for each leaf, its file, shape and logical dtype, under
  its key path joined by ``§`` and prefixed ``p`` (parameters) or ``o``
  (optimizer state);
* ``<n>.npy`` — one array per leaf, numbered in flattening order.

bfloat16 has no ``.npy`` type: its raw bits are stored as uint16, with
``"dtype": "bfloat16"`` in the manifest.  A tree is an ``nn.Module`` (its
``named_parameters()``, dots read as path separators), or nested dicts
(keys in sorted order, as ``jax.tree_util`` flattens them) and lists of
tensors or arrays.  A key holding ``/`` is a path: the optimizer's state,
keyed by the JAX package's leaf (``slots/s1/mlstm/wq``), is written under
the JAX package's own names (``o§slots§s1§mlstm§wq§_s_m``), so that each
package restores the other's optimizer state.

``restore_checkpoint`` loads in place: into the module's parameters and the
optimizer state's tensors, on whatever device each already lives, so a
restart resumes on the caller's card.  With ``strict=False`` a leaf the
checkpoint lacks keeps its current value.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step", "cleanup_old"]

_SEP = "§"


def _flatten(tree, prefix: Tuple = ()) -> Dict[str, Any]:
    """{key path joined by §: leaf} in the JAX package's flattening order."""
    if isinstance(tree, nn.Module):
        return {_SEP.join(prefix + tuple(name.split("."))): p
                for name, p in tree.named_parameters()}
    if isinstance(tree, dict):
        out = {}
        for parts, k in sorted((tuple(str(k).split("/")), k) for k in tree):
            out.update(_flatten(tree[k], prefix + parts))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flatten(v, prefix + (str(i),)))
        return out
    return {_SEP.join(prefix): tree}


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """(the array to store, its logical dtype's name)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
        return arr, str(arr.dtype)
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def save_checkpoint(ckpt_dir: str, step: int, params, opt_state=None,
                    extras: Optional[Dict] = None) -> str:
    """Write params (+ opt state, + extras) for ``step``; atomic via rename."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "extras": extras or {}, "arrays": {}}
    for prefix, tree in (("p", params), ("o", opt_state)):
        if tree is None:
            continue
        for key, leaf in _flatten(tree).items():
            arr, logical_dtype = _to_numpy(leaf)
            name = f"{prefix}{_SEP}{key}"
            fn = f"{len(manifest['arrays']):06d}.npy"
            np.save(os.path.join(tmp, fn), arr)
            manifest["arrays"][name] = {"file": fn, "shape": list(arr.shape),
                                        "dtype": logical_dtype}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def _steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
                  if d.startswith("step_") and not d.endswith(".tmp"))


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = _steps(ckpt_dir)
    return steps[-1] if steps else None


def restore_checkpoint(ckpt_dir: str, params_like, opt_like=None,
                       step: Optional[int] = None, strict: bool = True):
    """Load ``step`` (the latest by default) into ``params_like`` and
    ``opt_like`` in place, each tensor on its own device and in its own
    dtype.  Returns (step, params_like, opt_like, extras)."""
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)

    def load_tree(prefix, like):
        if like is None:
            return
        with torch.no_grad():
            for key, leaf in _flatten(like).items():
                name = f"{prefix}{_SEP}{key}"
                info = manifest["arrays"].get(name)
                if info is None:
                    if strict:
                        raise KeyError(f"checkpoint missing {name}")
                    continue      # keeps its current value (non-strict restore)
                arr = np.load(os.path.join(d, info["file"]))
                if info["dtype"] == "bfloat16":
                    src = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
                else:
                    src = torch.from_numpy(arr)
                if tuple(src.shape) != tuple(leaf.shape):
                    raise ValueError(f"{name} has shape {tuple(src.shape)} in the checkpoint, "
                                     f"{tuple(leaf.shape)} here")
                leaf.copy_(src.to(leaf.dtype))

    load_tree("p", params_like)
    load_tree("o", opt_like)
    return step, params_like, opt_like, manifest["extras"]


def cleanup_old(ckpt_dir: str, keep: int = 3) -> None:
    for s in _steps(ckpt_dir)[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"), ignore_errors=True)

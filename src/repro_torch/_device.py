"""Device resolution for the port's entry points."""

from __future__ import annotations

import contextlib

import torch

__all__ = ["resolve_device", "device_guard"]


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """Return ``device`` as a ``torch.device``; raise if it names no usable card.

    Entry points default to ``"cuda"``.  There is no silent fallback: a
    caller that wants the plain CPU versions passes ``device="cpu"``.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions of the kernels")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def device_guard(dev: torch.device):
    """A context that makes the card ``dev`` current in the calling thread.

    A kernel launches on the calling thread's current card, and a thread
    other than the one that chose a card starts on card 0; a CPU ``dev``
    gives a context that does nothing.
    """
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()

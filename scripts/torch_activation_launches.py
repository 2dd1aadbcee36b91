"""Launches a bfloat16 decode step adds for the port's activations, counted
from the code: for each model that ``chip_smoke.py`` phases 7-9 and 11 (d)
serve, at its full width and the depth the phase serves it at, one decode
step of B = 4 tokens runs on ``meta`` (nothing allocated) under a
``TorchDispatchMode`` that counts the ops on ``meta`` that are not views,
and the calls of ``layers.silu`` and ``layers.gelu_tanh`` with the ops
inside them.  In bfloat16 a ``silu`` is 5 ops where ``F.silu`` is 1, a
``gelu_tanh`` 9 where ``F.gelu`` is 1; on a card each op is one launch.
``before`` is the count with each call one op, as ``F.silu``/``F.gelu``
were.  The 11 (d) rows count the step unsharded; each rank of the mesh
calls every activation once as well, on its shard.

    PYTHONPATH=src python scripts/torch_activation_launches.py [--json OUT]
"""

import argparse
import dataclasses
import json
import sys
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

B = 4
# (phase, arch, layers or None for the config's own)
SERVED = [("7", "mistral-nemo-12b", None), ("8", "phi3.5-moe-42b-a6.6b", 28),
          ("8", "zamba2-1.2b", None), ("8", "xlstm-125m", None),
          ("9", "seamless-m4t-large-v2", None), ("11 (d)", "zamba2-1.2b", None),
          ("11 (d)", "seamless-m4t-large-v2", None), ("11 (d)", "phi3.5-moe-42b-a6.6b", 2)]


class Ops(TorchDispatchMode):
    """Counts the ops that are not views, in all and inside an activation."""

    def __init__(self):
        super().__init__()
        self.total = self.inside = 0
        self.depth = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        on_meta = any(isinstance(t, torch.Tensor) and t.is_meta
                      for t in (out if isinstance(out, (tuple, list)) else (out,)))
        if on_meta and not func.is_view:        # the host's own tensors launch nothing
            self.total += 1
            self.inside += self.depth > 0
        return out


def count(arch: str, layers) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models import layers as L
    from repro_torch.models import moe, ssm

    cfg = dataclasses.replace(get_config(arch), dtype="bfloat16")
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    model = build_model(cfg, device="meta")
    caches = model.init_cache(B, 8, 8) if cfg.is_encdec else model.init_cache(B, 8)
    mode, calls = Ops(), {"silu": 0, "gelu_tanh": 0}
    patched = []

    def wrap(mod, name, fn):
        def counted(x):
            calls[name] += x.dtype == torch.bfloat16
            mode.depth += 1
            try:
                return fn(x)
            finally:
                mode.depth -= 1
        patched.append((mod, name, fn))
        setattr(mod, name, counted)

    for mod in (L, moe, ssm):
        for name in calls:
            if hasattr(mod, name):
                wrap(mod, name, getattr(mod, name))
    token = torch.zeros((B, 1), dtype=torch.long, device="meta")
    try:
        with torch.no_grad(), mode:
            model.decode_step(token, caches, 4)
    finally:
        for mod, name, fn in patched:
            setattr(mod, name, fn)
    calls_n = calls["silu"] + calls["gelu_tanh"]
    return {"layers": cfg.num_layers, "silu_calls": calls["silu"],
            "gelu_calls": calls["gelu_tanh"], "ops_inside": mode.inside,
            "after": mode.total, "before": mode.total - mode.inside + calls_n,
            "added": mode.inside - calls_n}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--json", help="write the rows here too")
    args = ap.parse_args()
    rows = []
    for phase, arch, layers in SERVED:
        row = {"phase": phase, "arch": arch, **count(arch, layers)}
        rows.append(row)
        print(f"phase {phase}: {arch} ({row['layers']} layers), a bfloat16 decode step of "
              f"B = {B}: {row['silu_calls']} silu, {row['gelu_calls']} gelu_tanh calls "
              f"({row['ops_inside']} ops inside); ops that are not views {row['before']} "
              f"with each a single op, {row['after']} as the port is: +{row['added']}",
              flush=True)
    if args.json:
        Path(args.json).write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

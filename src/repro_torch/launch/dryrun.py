"""Multi-pod dry-run: run every (arch × shape) once on the production meshes
of a ``fake`` process group, and record memory, cost and collectives.

The port of the JAX package's ``launch/dryrun.py``, with its CLI and its
record's keys (``scripts/render_roofline_md.py`` renders either).  Where
the JAX package lowers and compiles a cell on 512 forced host devices, the
port runs it: this process initialises a ``fake`` group
(``torch.testing._internal.distributed.fake_pg``) of 256 ranks for the
pod mesh or 512 for the multi-pod one and plays rank 0 of it, with the
parameters, the optimizer state, the batch and the caches on ``meta``
(shapes without storage), placed as DTensors by
``steps.train_state_shardings`` and ``steps.input_shardings``
(``serve_rules`` for prefill and decode).  The cell's step runs once under
``roofline.StepCounter``, which counts FLOPs, dot bytes and collectives on
the shards this rank holds and the bytes the step allocates:

* ``argument_bytes``: the local bytes of what the step takes (parameters,
  optimizer state, batch, caches);
* ``temp_bytes``: the peak of the bytes that the step's operations
  allocated and still hold (the counter's storage tracking, not
  ``MemTracker``); ``output_bytes``: those still held when it returns;
* ``generated_code_bytes``: 0, there is no compiled program;
* ``peak_resident_bytes``: arguments plus temps, as the JAX package's.

The decode step's position is the cache's last slot (``seq_len - 1``).
A collective's bytes on a ``fake`` group are its shape's, nothing moves.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-27b \\
        --shape train_4k --mesh pod --out experiments/dryrun_torch/
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
import traceback
from typing import Dict, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

from repro_torch.configs import ARCH_IDS, SHAPES, get_config, shape_by_name
from repro_torch.launch import sharding as SH
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.roofline import StepCounter, model_flops, roofline_terms
from repro_torch.launch.steps import (abstract_inputs, abstract_train_state, build_decode_step,
                                      build_prefill_step, build_train_step, input_shardings,
                                      serve_rules, shard_model, train_state_shardings)
from repro_torch.models import build_model

__all__ = ["SKIP_LONG_CONTEXT", "applicable", "fake_group", "dryrun_cell", "run_cell", "main"]

SKIP_LONG_CONTEXT = {
    # pure full-attention archs: long_500k requires sub-quadratic attention
    "nemotron-4-340b", "mistral-large-123b", "mistral-nemo-12b",
    "phi3.5-moe-42b-a6.6b", "internvl2-26b", "seamless-m4t-large-v2",
}


def applicable(arch_id: str, shape_name: str) -> bool:
    if shape_name == "long_500k" and arch_id in SKIP_LONG_CONTEXT:
        return False
    return True


@contextlib.contextmanager
def fake_group(world: int):
    """``with fake_group(world):`` rank 0 of a ``fake`` process group of
    ``world`` ranks, destroyed on exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _local_bytes(tree, seen: Optional[set] = None) -> int:
    """Bytes of the tensors of a tree as this rank holds them (a DTensor's
    local shard), each storage once."""
    seen = set() if seen is None else seen
    if isinstance(tree, dict):
        return sum(_local_bytes(v, seen) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_local_bytes(v, seen) for v in tree)
    if isinstance(tree, torch.Tensor):
        if id(tree) in seen:
            return 0
        seen.add(id(tree))
        t = tree.to_local() if isinstance(tree, DTensor) else tree
        return t.numel() * t.element_size()
    return 0


def dryrun_cell(arch_id: str, shape_name: str, mesh_name: str, rules: Optional[Dict] = None,
                verbose: bool = True) -> dict:
    """Run one cell on its production mesh under the counter; returns the
    record dict.  Needs a process group of the mesh's size
    (:class:`fake_group`)."""
    mesh = make_production_mesh(multi_pod=(mesh_name == "multipod"))
    return run_cell(get_config(arch_id), shape_by_name(shape_name), mesh, mesh_name, rules,
                    verbose)


def run_cell(cfg, shape, mesh: DeviceMesh, mesh_name: str, rules: Optional[Dict] = None,
             verbose: bool = True) -> dict:
    """:func:`dryrun_cell` on any ``("data", "model")`` or ``("pod",
    "data", "model")`` mesh, for any config and shape (a cell cut down)."""
    arch_id, shape_name = cfg.name, shape.name
    chips = mesh.size()
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    if shape.kind in ("prefill", "decode") and rules is None:
        # serving: TP-only weights where they fit (see steps.serve_rules)
        rules = serve_rules(cfg, tp=sizes["model"]) or None
    t0 = time.time()

    model = shard_model(build_model(cfg, device="meta"), mesh, rules)
    batch = SH.place(abstract_inputs(cfg, shape), input_shardings(cfg, shape, mesh, rules))
    args: list = [model, batch]
    if shape.kind == "train":
        _, opt_abs, opt = abstract_train_state(cfg)
        state = SH.place(opt_abs, train_state_shardings(cfg, mesh, rules)[1])
        step_fn = build_train_step(cfg, shape, mesh, opt)
        args = [model, state, 0, batch]
    elif shape.kind == "prefill":
        step_fn = build_prefill_step(cfg)
    else:
        batch["pos"] = torch.tensor(shape.seq_len - 1, dtype=torch.int32)
        step_fn = build_decode_step(cfg)
    arg_bytes = _local_bytes([dict(model.named_parameters())] + args[1:])
    group_sizes = {mesh.get_group(i).group_name: n for i, n in enumerate(mesh.shape)}
    with mesh, StepCounter(group_sizes) as counter:
        out = step_fn(*args)
    output_bytes = counter.live_bytes
    del out
    temp_bytes = counter.peak_bytes
    peak_resident = arg_bytes + temp_bytes
    cost = {"flops": counter.flops, "bytes accessed": counter.dot_bytes}
    rl = roofline_terms(arch_id, shape_name, mesh_name, chips, cost, counter.collectives,
                        float(peak_resident), model_flops(cfg, shape))

    record = {
        "arch": arch_id, "shape": shape_name, "mesh": mesh_name,
        "chips": chips, "compile_s": round(time.time() - t0, 1),
        "memory": {
            "argument_bytes": arg_bytes,
            "output_bytes": output_bytes,
            "temp_bytes": temp_bytes,
            "generated_code_bytes": 0,
            "peak_resident_bytes": peak_resident,
        },
        "cost": cost,
        "roofline": rl.to_dict(),
        "status": "ok",
    }
    if verbose:
        print(f"[dryrun] {arch_id} × {shape_name} × {mesh_name}: "
              f"run={record['compile_s']}s "
              f"mem/chip={peak_resident/1e9:.2f}GB "
              f"flops/chip={cost['flops']:.3e} "
              f"coll/chip={rl.coll_bytes_per_chip:.3e}B "
              f"dominant={rl.dominant} "
              f"roofline_frac={rl.roofline_fraction:.3f}", flush=True)
        print(f"  memory: args={arg_bytes/1e9:.2f}GB out={output_bytes/1e9:.2f}GB "
              f"temp={temp_bytes/1e9:.2f}GB", flush=True)
        print(f"  cost: {record['cost']}", flush=True)
    return record


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default=None, choices=list(ARCH_IDS))
    ap.add_argument("--shape", default=None, choices=[s.name for s in SHAPES])
    ap.add_argument("--mesh", default="pod", choices=["pod", "multipod", "both"])
    ap.add_argument("--all", action="store_true",
                    help="run every applicable (arch × shape)")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    meshes = ["pod", "multipod"] if args.mesh == "both" else [args.mesh]
    archs = list(ARCH_IDS) if (args.all or not args.arch) else [args.arch]
    shapes = [s.name for s in SHAPES] if (args.all or not args.shape) else [args.shape]

    failures = 0
    for mesh_name in meshes:
        with fake_group(512 if mesh_name == "multipod" else 256):
            for arch in archs:
                for shp in shapes:
                    tag = f"{arch}__{shp}__{mesh_name}"
                    path = os.path.join(args.out, tag + ".json")
                    if not applicable(arch, shp):
                        rec = {"arch": arch, "shape": shp, "mesh": mesh_name,
                               "status": "skip", "reason": "full-attention arch; "
                               "long_500k needs sub-quadratic attention"}
                        with open(path, "w") as f:
                            json.dump(rec, f, indent=2)
                        print(f"[dryrun] SKIP {tag} (full attention)")
                        continue
                    try:
                        rec = dryrun_cell(arch, shp, mesh_name)
                    except Exception as e:  # noqa: BLE001 — record and continue
                        traceback.print_exc()
                        rec = {"arch": arch, "shape": shp, "mesh": mesh_name,
                               "status": "fail", "error": f"{type(e).__name__}: {e}"}
                        failures += 1
                    with open(path, "w") as f:
                        json.dump(rec, f, indent=2)
    print(f"[dryrun] done; failures={failures}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())

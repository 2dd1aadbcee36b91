"""How far a float32 train step lies from the same step in float64, at
several microbatch counts.

``chip_smoke.py`` phase 11 (e) holds the sharded train step of
zamba2-1.2b to the same step unsharded in float64 (the witness).  This
script takes that step unsharded in float32 at each microbatch count given
and holds each to the witness as phase 11 (e) holds its ranks: every
parameter after the step against the witness's, its error over the
witness's largest update of it, less the half float32 ulp of its largest
value (``chip_smoke.update_rel_err``); and over its largest value.  It
prints the worst leaf of each kind (the leaves that start at zero, Mamba-2's
``a_log`` and ``dt_bias``, and the others), then one JSON line.

    python examples/torch_train_precision.py                  # on the card
    python examples/torch_train_precision.py --device cpu --reduced
"""

import argparse
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as CS  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true", help="the reduced config and cell")
    ap.add_argument("--accum", type=int, nargs="+", default=[1, 2, 4],
                    help="microbatch counts of the float32 steps")
    ap.add_argument("--witness-accum", type=int, default=4,
                    help="microbatch count of the float64 step")
    ap.add_argument("--seq", type=int, default=0,
                    help="tokens a sample (default: phase 11 (e)'s)")
    ap.add_argument("--json", type=Path, help="also write the record here")
    args = ap.parse_args()
    dev = torch.device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    import dataclasses

    cfg = dataclasses.replace(CS.mesh_config(CS.MESH_TRAIN_ARCH, args.reduced), dtype="float32")
    shape, tokens = CS.mesh_train_inputs(cfg, args.reduced, dev, args.seq)
    start: dict = {}
    t0 = time.perf_counter()
    model, witness, secs, peak = CS.mesh_train_unsharded(dev, args.reduced, "float64", tokens,
                                                         shape, args.witness_accum, start)
    with torch.no_grad():
        update = {n: (p - start[n].to(dev, torch.float64)).float().cpu()
                  for n, p in model.named_parameters()}
    del model
    zero = {n for n, t in start.items() if not bool(t.any())}
    print(f"witness: float64 at {args.witness_accum} microbatches, loss {witness['loss']:.9f}, "
          f"gradient norm {witness['grad_norm']:.9f}, step {secs:.3f} s, peak {peak:.3f} GB, "
          f"{time.perf_counter() - t0:.1f} s in all", flush=True)
    record = {"arch": cfg.name, "batch": shape.global_batch, "seq": shape.seq_len,
              "witness_accum": args.witness_accum, "witness": witness, "runs": {}}
    for accum in args.accum:
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        model, got, secs, peak = CS.mesh_train_unsharded(dev, args.reduced, "float32", tokens,
                                                         shape, accum)
        with torch.no_grad():
            held = {n: CS.held_to_witness(n, p, start, update)
                    for n, p in model.named_parameters()}
        del model
        rel = {n: CS.update_rel_err(e) for n, e in held.items()}
        run = {"loss": got["loss"], "grad_norm": got["grad_norm"], "step_s": secs,
               "peak_gb": peak, "finite": all(e[3] for e in held.values())}
        for kind, names in (("zero_start", zero), ("others", set(rel) - zero)):
            name = max(names, key=rel.get)
            run[kind] = {"update_rel_err": rel[name], "leaf": name,
                         "value_rel_err": max(held[n][0] / held[n][2] for n in names)}
        record["runs"][accum] = run
        print(f"float32 at {accum} microbatches ({shape.global_batch // accum} samples each): "
              f"loss {got['loss']:.9f}, gradient norm {got['grad_norm']:.9f}; largest error "
              f"over the witness's largest update: the {len(zero)} leaves that start at zero "
              f"{run['zero_start']['update_rel_err']:.3e} ({run['zero_start']['leaf']}), the "
              f"{len(rel) - len(zero)} others {run['others']['update_rel_err']:.3e} "
              f"({run['others']['leaf']}); over the largest value "
              f"{run['zero_start']['value_rel_err']:.3e} and {run['others']['value_rel_err']:.3e}"
              f"; step {secs:.3f} s, peak {peak:.3f} GB", flush=True)
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(record))
    print(json.dumps(record))
    return 0 if all(r["finite"] for r in record["runs"].values()) else 1


if __name__ == "__main__":
    sys.exit(main())

"""``chip_smoke.py`` phase 11 (d)'s bfloat16 serving on the card, with the
numbers behind its first-token check in place of its checks: for each of
MESH_SERVE_ARCHS, the unsharded bfloat16 run's distance from float32 and
each rank's from the unsharded bfloat16 run, at the prefill and at each
step (over the float32 run's largest logit, as ``chip_smoke.rel_by_step``),
the first step's greedy tokens of both, the unsharded first step's gap
between its two largest logits by row, and how many of the greedy tokens
agree.

    python3 scripts/torch_mesh_serve_tokens.py     # on the card

It needs one card (about 100 s; no kernel is built).
"""

import json
import multiprocessing
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src"), str(ROOT / "tests")]


def main() -> int:
    import torch

    import chip_smoke as CS

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    b, prompt, steps = CS.MESH_SERVE_TRAFFIC
    world = CS.MESH_SERVE_SHAPE[0] * CS.MESH_SERVE_SHAPE[1]
    tmp = Path(tempfile.mkdtemp(prefix="mesh_serve_tokens_"))
    t0 = time.perf_counter()
    refs, procs = {}, []
    try:
        for arch in CS.MESH_SERVE_ARCHS:             # as chip_smoke.mesh_serve draws and feeds
            feed = None
            for dtype in ("bfloat16", "float32"):
                cfg, model = CS.mesh_serve_model(arch, False, dtype, dev)
                refs[arch, dtype] = run = CS.mesh_serve_run(
                    model, cfg, CS.mesh_serve_inputs(cfg, b, prompt, dev), steps, feed)
                feed = run["fed"]
                del run["caches"], model
                torch.save(feed, tmp / f"feed_{arch}_{dtype}.pt")
                torch.cuda.empty_cache()
        (tmp / "spec.json").write_text(json.dumps({
            "device": "cuda", "shape": list(CS.MESH_SERVE_SHAPE),
            "archs": list(CS.MESH_SERVE_ARCHS), "traffic": [b, prompt, steps], "reduced": False}))
        ctx = multiprocessing.get_context("spawn")
        procs = [ctx.Process(target=CS.mesh_serve_rank, args=(r, world, str(tmp)))
                 for r in range(world)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(CS.MESH_SERVE_TIMEOUT)
        codes = [p.exitcode for p in procs]
        if any(codes):
            print(f"ranks exited with {codes}", file=sys.stderr)
            return 1
        ranks = [torch.load(tmp / f"rank{r}.pt") for r in range(world)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"served in {time.perf_counter() - t0:.1f} s")
    for arch in CS.MESH_SERVE_ARCHS:
        f32, ref = refs[arch, "float32"], refs[arch, "bfloat16"]
        scale = max(float(f32["prefill"].abs().max()), float(f32["logits"].abs().max()))
        top2 = ref["logits"][0].topk(2, dim=-1).values
        print(f"  {arch}: unsharded bfloat16 from float32 "
              f"{[round(e, 4) for e in CS.rel_by_step(ref, f32)]}; first step's top-two gaps "
              f"{[round(float(g), 5) for g in top2[:, 0] - top2[:, 1]]}; first tokens "
              f"{ref['greedy'][:, 0].tolist()}")
        for r, out in enumerate(ranks):
            run = out[arch, "bfloat16"]
            apart = [run["prefill"] - ref["prefill"]] + [
                x - y for x, y in zip(run["logits"], ref["logits"])]
            print(f"    rank {r}: from the unsharded bfloat16 run "
                  f"{[round(float(d.abs().max()) / scale, 4) for d in apart]}; first tokens "
                  f"{run['greedy'][:, 0].tolist()}; greedy tokens agree "
                  f"{int((run['greedy'] == ref['greedy']).sum())} of {ref['greedy'].numel()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Time ``coded_matvec``'s split-row stream over its slice width, on one
NVIDIA card, at PageRank's and the graph filter's shapes, and beside the
stream at the stream's own shapes.

    python3 scripts/split_sweep.py [--reps 3] [--out sweep.json]

The shapes are those of ``chip_smoke.py`` phase 6 (c): 200 of 240 assigned
blocks of a (12, 10)-coded matrix in C = 20 chunks, 164 rows of d = 32,768
float32 (PageRank on 32,768 nodes) and 82 rows of d = 16,384 (the filter on
16,384), random from a seed.  The slice width is a compile-time constant of
``csrc/coded_matvec.cu`` (``S2C2_SPLIT_SLICE_BYTES``, 32 KB in the library);
for each other width in ``WIDTHS`` the script compiles that file alone with
a ``-D`` under ``build/split_sweep/<width>/`` and binds its
``s2c2_coded_matvec_split``.  Each width is held against the plain version
at 2e-4 and timed with CUDA events over back-to-back launches, in turns (the
list forward, then backward, ``reps`` times), beside the general design and
``torch.matmul`` on the rows gathered beforehand.  Two probes time the
library's split design beside them: at d + 64 (rows off a power of two),
and against the stream over the same bytes in rows of 32 KB.  Last, the
split design, through the library's entry point (the wrapper sends rows of
at most 32 KB to the stream), is timed in turns against the stream at two
of the stream's shapes: the main path's 200 of 240 blocks of 3,000 rows of
d = 2,048 float32 (8 KB rows) and 200 of 240 blocks of 1,200 rows of d =
5,000 (20 KB rows, the coded LR matrix's width).  It prints the card's name
and power limit and one JSON object, and writes the same object to ``--out``
where one is given.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12       # H100 SXM, NVIDIA's data sheet
BLOCKS, ASSIGNED = 240, 200
SHAPES = {"pagerank": (164, 32_768), "filter": (82, 16_384)}
STREAM_SHAPES = {"main path": (3_000, 2_048), "d = 5,000": (1_200, 5_000)}
WIDTHS = (8 * 1024, 16 * 1024)  # slice bytes built besides the library's 32 KB
LAUNCHES = 40
STREAM_D = 8_192                # the stream's widest float32 row: 32 KB
BUILD = ROOT / "build" / "split_sweep"


def build_widths(_build) -> dict:
    """Compile ``coded_matvec.cu`` once per width in ``WIDTHS`` (all at once)
    and return width -> the bound ``s2c2_coded_matvec_split``."""
    nvcc = _build._nvcc()
    if nvcc is None:
        raise RuntimeError("nvcc not found")
    procs = {}
    for width in WIDTHS:
        out_dir = BUILD / str(width)
        out_dir.mkdir(parents=True, exist_ok=True)
        lib = out_dir / "libsplit.so"
        cmd = [nvcc, *_build.ARCH_FLAGS, *_build.NVCC_FLAGS, f"-DS2C2_SPLIT_SLICE_BYTES={width}",
               "-shared", "-o", str(lib), str(_build.CSRC / "coded_matvec.cu")]
        procs[width] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                              stderr=subprocess.STDOUT, text=True))
    fns = {}
    for width, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"build at {width} bytes failed:\n{log}")
        fn = ctypes.CDLL(str(lib)).s2c2_coded_matvec_split
        fn.argtypes = _build._SIGNATURES["s2c2_coded_matvec_split"]
        fn.restype = ctypes.c_int
        fns[width] = fn
    return fns


def in_turns(torch, versions: dict, reps: int) -> dict:
    """name -> the device ms a launch, for each turn."""
    times = {name: [] for name in versions}
    order = list(versions)
    for _ in range(reps):
        for name in order + order[::-1]:
            f = versions[name]
            f()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(LAUNCHES):
                f()
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end) / LAUNCHES)
    return times


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", help="also write the JSON object to this file")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("split_sweep: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    from repro_torch.kernels import coded_matvec as cmv

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda")
    fns = {**build_widths(_build), 32 * 1024: _build.kernel("s2c2_coded_matvec_split")}
    result = {"card": card, "shapes": {}}

    def split(fn, a, x, ids, br, out, label):
        err = fn(a.data_ptr(), x.data_ptr(), ids.data_ptr(), out.data_ptr(),
                 a.shape[0] // br, ids.shape[0], br, a.shape[1], _build.DTYPE_CODES[a.dtype],
                 _build.stream_of(a))
        _build.check(err, label)

    def held(fn, a, x, ids, br, label):
        """A closure launching ``fn``, held against the plain version first."""
        out = torch.empty(ids.shape[0], br, device=dev, dtype=a.dtype)
        split(fn, a, x, ids, br, out, label)
        want = cmv.coded_matvec_plain(a, x, ids, br)
        torch.cuda.synchronize()
        err = float((out - want).abs().max())
        if not torch.allclose(out, want, rtol=2e-4, atol=2e-4):
            raise RuntimeError(f"{label}: max abs err {err:.3e}")
        return (lambda: split(fn, a, x, ids, br, out, label)), err

    def report(label, br, d, versions, errs):
        times = in_turns(torch, versions, args.reps)
        bound = 4 * (ASSIGNED * br * d + d + ASSIGNED + ASSIGNED * br) / HBM_BYTES_PER_S * 1e3
        best = {name: min(ts) for name, ts in times.items()}
        result["shapes"][label] = dict(br=br, d=d, nb=ASSIGNED, bound_ms=bound, best_ms=best,
                                       ms=times, max_abs_err=errs)
        for name, t in sorted(best.items(), key=lambda kv: kv[1]):
            print(f"{label}: {name}: best {t:.4f} ms, {bound / t * 100:.1f} % of the "
                  f"{bound:.4f} ms bound", flush=True)

    for label, (br, d) in SHAPES.items():
        gen = torch.Generator(device=dev).manual_seed(3)
        a = torch.randn(BLOCKS * br, d, generator=gen, device=dev)
        x = torch.randn(d, generator=gen, device=dev)
        ids = torch.randperm(BLOCKS, generator=gen, device=dev)[:ASSIGNED].to(torch.int32)
        sel = a.view(BLOCKS, br, d)[ids.long()].reshape(-1, d)
        versions, errs = {}, {}
        for width, fn in sorted(fns.items()):
            name = f"split, {width // 1024} KB slices"
            versions[name], errs[name] = held(fn, a, x, ids, br, f"{label} {name}")
        versions["general"] = lambda: cmv.coded_matvec_general(a, x, ids, br)
        versions["torch.matmul on pre-gathered rows"] = lambda: torch.matmul(sel, x)
        # the probes: the same rows 64 columns wider; the same bytes as the
        # stream takes them, rows of 8,192 float32 in blocks of br·d / 8,192
        a_wide = torch.randn(BLOCKS * br, d + 64, generator=gen, device=dev)
        x_wide = torch.randn(d + 64, generator=gen, device=dev)
        br_s = br * d // STREAM_D
        a_s = torch.randn(BLOCKS * br_s, STREAM_D, generator=gen, device=dev)
        x_s = torch.randn(STREAM_D, generator=gen, device=dev)
        versions["probe: split at d + 64"] = (
            lambda: cmv.coded_matvec_split(a_wide, x_wide, ids, br))
        versions["probe: stream, same bytes in 32 KB rows"] = (
            lambda: cmv.coded_matvec_stream(a_s, x_s, ids, br_s))
        report(label, br, d, versions, errs)
        del a, sel, a_wide, a_s, versions
        torch.cuda.empty_cache()

    for label, (br, d) in STREAM_SHAPES.items():
        gen = torch.Generator(device=dev).manual_seed(4)
        a = torch.randn(BLOCKS * br, d, generator=gen, device=dev)
        x = torch.randn(d, generator=gen, device=dev)
        ids = torch.randperm(BLOCKS, generator=gen, device=dev)[:ASSIGNED].to(torch.int32)
        errs = {}
        versions = {"stream": lambda: cmv.coded_matvec_stream(a, x, ids, br)}
        versions["split, 32 KB slices"], errs["split, 32 KB slices"] = held(
            fns[32 * 1024], a, x, ids, br, f"{label} split")
        report(label, br, d, versions, errs)
        del a, versions
        torch.cuda.empty_cache()

    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps({name: shape["best_ms"] for name, shape in result["shapes"].items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

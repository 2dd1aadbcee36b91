"""Per-chip counts of the port's steps on a 2 × 2 ``("data", "model")``
mesh against the JAX package's, on the CPU.

For a reduced float32 config of each family (``attn_mlp`` with global and
with local/global attention, ``vit_stub``, ``attn_moe``, Mamba-2 with the
shared attention block, the xLSTM, the encoder-decoder), the port's train,
prefill and decode steps run once on ``meta`` under a ``fake`` group of 4
ranks (``launch.dryrun.run_cell``: the weights and optimizer state placed
by ``train_state_shardings``, ``serve_rules`` for serving, the batch and
caches by ``input_shardings``) and ``roofline.StepCounter`` counts rank 0's
FLOPs and collectives.  The JAX package's same three steps are jitted with
the same shardings and compiled on 4 forced host devices
(``--xla_force_host_platform_device_count=4``), as its ``launch/dryrun.py``
compiles a cell, and its FLOPs taken as its dry-run takes them (the larger
of ``cost_analysis`` and ``hlo_cost``, which counts the loops' trip counts)
and its collective bytes from the compiled HLO (``roofline_terms``).  Each
side runs in processes of its own, all at once: process groups and XLA's
device count are global state.

* A train step's FLOPs within ``TRAIN_FLOP_BAND`` of the JAX package's,
  but for the MoE's (``INDEX_DISPATCH``), whose dispatch by index counts
  other work than the JAX package's one-hot products.
* The MoE's train step and every prefill and decode step within
  ``FLOP_BAND``, or, where the unsharded step's band in
  ``tests/test_torch_roofline.py`` (``BANDS``) is wider than
  ``FLOP_BAND``, within that band plus ``FLOP_BAND_EXTRA``: the sharded
  steps differ as the unsharded ones do (the MoE's dispatch by index, the
  sLSTM's backward) and by how each partitions its work.
* Collective bytes at most ``COLLECTIVE_RATIO`` times the JAX package's.

``MEASURED`` holds the ratios measured (port / JAX) when the file was
written, for the reader; the assertions use the bands alone.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from test_torch_roofline import BANDS

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 80         # seconds, every process
B, S = 4, 32
MESH = (2, 2)
ARCHS = ["mistral-nemo-12b", "gemma3-27b", "internvl2-26b", "phi3.5-moe-42b-a6.6b",
         "zamba2-1.2b", "xlstm-125m", "seamless-m4t-large-v2"]
KINDS = ["train", "prefill", "decode"]
FLOP_BAND = 0.2
FLOP_BAND_EXTRA = 0.1
# a train step's FLOPs (the MoE's aside) within 1 +- TRAIN_FLOP_BAND of the
# JAX package's: no rank repeats another's work (measured within 3.3 %)
TRAIN_FLOP_BAND = 0.05
INDEX_DISPATCH = "phi3.5-moe-42b-a6.6b"
COLLECTIVE_RATIO = 1.5
# (arch, kind) -> (FLOPs, collective bytes), port / JAX, measured
MEASURED = {
    ("mistral-nemo-12b", "train"): (1.000, 0.601),
    ("mistral-nemo-12b", "prefill"): (0.979, 1.000),
    ("mistral-nemo-12b", "decode"): (0.977, 1.001),
    ("gemma3-27b", "train"): (0.975, 0.566),
    ("gemma3-27b", "prefill"): (0.975, 1.000),
    ("gemma3-27b", "decode"): (0.974, 1.001),
    ("internvl2-26b", "train"): (0.993, 0.432),
    ("internvl2-26b", "prefill"): (0.978, 1.000),
    ("internvl2-26b", "decode"): (0.977, 1.001),
    ("phi3.5-moe-42b-a6.6b", "train"): (0.837, 1.051),
    ("phi3.5-moe-42b-a6.6b", "prefill"): (0.855, 0.465),
    ("phi3.5-moe-42b-a6.6b", "decode"): (0.985, 0.360),
    ("zamba2-1.2b", "train"): (0.982, 0.569),
    ("zamba2-1.2b", "prefill"): (0.943, 0.548),
    ("zamba2-1.2b", "decode"): (0.941, 0.741),
    ("xlstm-125m", "train"): (1.033, 0.830),
    ("xlstm-125m", "prefill"): (0.871, 0.434),
    ("xlstm-125m", "decode"): (0.915, 1.042),
    ("seamless-m4t-large-v2", "train"): (1.002, 0.552),
    ("seamless-m4t-large-v2", "prefill"): (1.000, 1.000),
    ("seamless-m4t-large-v2", "decode"): (0.964, 1.001),
}

PORT = textwrap.dedent("""
    import json, sys
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.dryrun import fake_group, run_cell
    arch, b, s, shape = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), json.loads(sys.argv[4])
    cfg = get_config(arch).reduced()
    out = {}
    with fake_group(shape[0] * shape[1]):
        mesh = init_device_mesh("cpu", tuple(shape), mesh_dim_names=("data", "model"))
        for kind in ("train", "prefill", "decode"):
            rl = run_cell(cfg, ShapeConfig("smoke_" + kind, s, b, kind), mesh, "2x2",
                          verbose=False)["roofline"]
            out[kind] = [rl["flops_per_chip"], rl["coll_bytes_per_chip"]]
    print(json.dumps(out))
""")

JAX = textwrap.dedent("""
    import os, sys, json
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=4").strip()
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.configs import get_config
    from repro.configs.base import ShapeConfig
    from repro.launch import sharding as SH
    from repro.launch.roofline import hlo_cost, roofline_terms
    from repro.launch.steps import (abstract_inputs, abstract_train_state, build_decode_step,
                                    build_prefill_step, build_train_step, input_shardings,
                                    serve_rules, train_state_shardings)
    try:
        from jax.sharding import AxisType
        kw = {"axis_types": (AxisType.Auto,) * 2}
    except ImportError:
        kw = {}
    arch, b, s, shape = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), json.loads(sys.argv[4])
    cfg = get_config(arch).reduced()
    mesh = jax.make_mesh(tuple(shape), ("data", "model"), **kw)
    out = {}
    for kind in ("train", "prefill", "decode"):
        cell = ShapeConfig("smoke_" + kind, s, b, kind)
        rules = None if kind == "train" else (serve_rules(cfg, tp=shape[1]) or None)
        with mesh:
            batch_abs = abstract_inputs(cfg, cell)
            batch_sh = input_shardings(cfg, cell, mesh, rules)
            params_abs, opt_abs, opt = abstract_train_state(cfg)
            params_sh, opt_sh = train_state_shardings(cfg, mesh, rules)
            if kind == "train":
                fn = jax.jit(build_train_step(cfg, cell, mesh, opt),
                             in_shardings=(params_sh, opt_sh, NamedSharding(mesh, P()), batch_sh),
                             out_shardings=(params_sh, opt_sh, None), donate_argnums=(0, 1))
                lowered = fn.lower(params_abs, opt_abs,
                                   jax.ShapeDtypeStruct((), jax.numpy.int32), batch_abs)
            elif kind == "prefill":
                step = build_prefill_step(cfg)
                logits, caches = jax.eval_shape(step, params_abs, batch_abs)
                logits_sh = NamedSharding(mesh, SH.resolve_axes(("batch", "vocab"), logits.shape,
                                                                mesh, rules))
                caches_sh = SH.cache_sharding_rules(mesh, caches, rules)
                fn = jax.jit(step, in_shardings=(params_sh, batch_sh),
                             out_shardings=(logits_sh, caches_sh))
                lowered = fn.lower(params_abs, batch_abs)
            else:
                fn = jax.jit(build_decode_step(cfg), in_shardings=(params_sh, batch_sh),
                             out_shardings=(batch_sh["token"], batch_sh["caches"]),
                             donate_argnums=(1,))
                lowered = fn.lower(params_abs, batch_abs)
            compiled = lowered.compile()
        cost = compiled.cost_analysis()
        cost = cost[0] if isinstance(cost, list) else cost
        hlo = compiled.as_text()
        flops = max(float(cost.get("flops", 0.0)), hlo_cost(hlo)[0])
        rl = roofline_terms(arch, kind, "2x2", 4, {"flops": flops}, hlo, 0.0, 0.0)
        out[kind] = [flops, rl.coll_bytes_per_chip]
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def counts():
    """{arch: (the port's {kind: [flops, collective bytes]}, the JAX package's)},
    every process started at once."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1",
           "JAX_PLATFORMS": "cpu"}
    args = [str(B), str(S), json.dumps(MESH)]
    procs = {(arch, side): subprocess.Popen([sys.executable, "-c", script, arch, *args],
                                            env=env, stdout=subprocess.PIPE,
                                            stderr=subprocess.PIPE, text=True, cwd=ROOT)
             for arch in ARCHS for side, script in (("port", PORT), ("jax", JAX))}
    out = {}
    try:
        for key, p in procs.items():
            stdout, stderr = p.communicate(timeout=TIMEOUT)
            assert p.returncode == 0, (key, stderr[-3000:])
            out[key] = json.loads(stdout.strip().splitlines()[-1])
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return {arch: (out[arch, "port"], out[arch, "jax"]) for arch in ARCHS}


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_per_chip_counts_match_the_jax_package(counts, arch, kind):
    (flops, coll), (jflops, jcoll) = counts[arch][0][kind], counts[arch][1][kind]
    if kind == "train" and arch != INDEX_DISPATCH:
        band = TRAIN_FLOP_BAND
    else:
        band = max(FLOP_BAND, BANDS.get((arch, kind), (0.0, 0.0))[0] + FLOP_BAND_EXTRA)
    assert abs(flops / jflops - 1) <= band, (flops / jflops, band, MEASURED[arch, kind])
    assert coll <= COLLECTIVE_RATIO * jcoll, (coll / jcoll, MEASURED[arch, kind])

"""The port's roofline (``repro_torch.launch.roofline``) against the JAX
package's (``repro.launch.roofline``).

* ``_ring_factor`` and ``RooflineResult``'s terms, as
  ``tests/test_roofline.py`` pins the reference's, with the H100's
  data-sheet constants in place of the TPU's.
* ``model_flops`` equals the JAX package's for every arch and shape.
* ``StepCounter`` counts what one rank holds: on the ``(16, 16)`` mesh of
  a ``fake`` group of 256 ranks (in a subprocess: process groups are
  global state), a ``Shard(0) @ Shard(1)`` product counts 1/256 of its
  unsharded FLOPs and the all-gather DTensor issues to replicate its
  result; a replicated product counts all of them.
* ``step_cost`` of one reduced float32 train, prefill and decode step per
  family, on the CPU, against the JAX package's ``hlo_cost`` of the same
  jitted step (the same weights and batch).  The same matmuls give the
  same counts: the port's are exact where it runs the same ones (the
  prefill too: it hands the K and V of its one projection to the cache,
  as XLA's common-subexpression elimination merges the JAX package's two),
  and otherwise differ as follows.

  - ``attn_moe``: the JAX package dispatches and combines with one-hot
    einsums, which count as dots, and the port by index copies and
    ``index_add_``, which do not: the port counts up to 12.6 % fewer.
  - gemma3's local/global train step: the backward of the windowed
    blockwise attention, XLA's autodiff of its scans against autograd of
    the port's loops: 2.6 % fewer FLOPs in the port.
  - Mamba-2 and the mLSTM: contractions that one package writes as a dot
    and the other as an elementwise product and a sum: within 2.1 % in
    FLOPs and 4.6 % in dot bytes.
  - The sLSTM's backward: the JAX package's custom VJP against autograd
    through the port's loop: 3.8 % fewer FLOPs and 32 % fewer dot bytes
    in the port.

  ``BANDS`` holds each of these as the largest relative difference
  allowed, a little above the measured one (beside it); every other
  count must be exact.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cuda import jax_on_cpu  # noqa: F401  (fixture)
from repro.configs import get_config as jax_config
from repro.configs.base import ShapeConfig as JaxShape
from repro.launch import roofline as JR
from repro.launch import steps as JS
from repro.models import build_model as jax_build
from repro.models.params import initialize as jax_initialize
from repro.optim.optimizer import make_optimizer as jax_optimizer
from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.convert import group, lm_params_from_jax
from repro_torch.launch import roofline as R
from repro_torch.launch import steps as S
from repro_torch.models import build_model
from repro_torch.optim.optimizer import make_optimizer

pytestmark = pytest.mark.usefixtures("jax_on_cpu")   # the JAX reference on the CPU

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
B, SEQ, LR = 4, 16, 1e-2
FAMILIES = ["mistral-nemo-12b", "gemma3-27b", "internvl2-26b", "phi3.5-moe-42b-a6.6b",
            "zamba2-1.2b", "xlstm-125m", "seamless-m4t-large-v2"]
# (arch, step kind) -> (flops, dot bytes): the largest |port / JAX - 1|
# allowed; 0 where exact
BANDS = {
    ("gemma3-27b", "train"): (0.03, 0.025),                 # measured 2.6 %, 2.2 %
    ("phi3.5-moe-42b-a6.6b", "prefill"): (0.13, 0.13),      # 12.1 %, 12.6 %
    ("phi3.5-moe-42b-a6.6b", "train"): (0.10, 0.10),        # 9.0 %, 9.8 %
    ("phi3.5-moe-42b-a6.6b", "decode"): (0.01, 0.012),      # 0.9 %, 1.1 %
    ("zamba2-1.2b", "train"): (0.025, 0.05),                # 2.1 %, 4.6 %
    ("zamba2-1.2b", "decode"): (0.01, 0.03),                # 0.6 %, 2.8 %
    ("xlstm-125m", "prefill"): (0.002, 0.04),               # 0.13 %, 3.4 %
    ("xlstm-125m", "train"): (0.04, 0.33),                  # 3.8 %, 32.5 %
    ("xlstm-125m", "decode"): (0.001, 0.005),               # 0.06 %, 0.4 %
}


def test_ring_factors():
    # all-reduce moves 2(k-1)/k of the tensor
    assert R._ring_factor("all-reduce", 4, 100) == pytest.approx(150.0)
    assert R._ring_factor("all-gather", 4, 100) == pytest.approx(75.0)
    assert R._ring_factor("reduce-scatter", 4, 100) == pytest.approx(300.0)
    assert R._ring_factor("collective-permute", 4, 100) == 100.0
    assert R._ring_factor("all-reduce", 1, 100) == 0.0


def test_collective_bytes_sums_each_kind_through_the_ring():
    record = [R.Collective("all-reduce", 4, 256), R.Collective("all-reduce", 4, 256),
              R.Collective("all-gather", 4, 1024), R.Collective("all-gather", 1, 1024)]
    assert R.collective_bytes(record) == {"all-reduce": pytest.approx(2 * 256 * 1.5),
                                          "all-gather": pytest.approx(1024 * 0.75)}


def test_roofline_result_terms():
    hw = R.H100
    assert (hw.peak_flops, hw.hbm_bw, hw.link_bw, hw.hbm_per_chip) == (989e12, 3.35e12, 50e9,
                                                                       80e9)
    r = R.RooflineResult(
        arch="x", shape="train_4k", mesh="pod", chips=256,
        flops_per_chip=989e12 * 0.5,          # half a second of compute
        bytes_per_chip=3.35e12 * 0.1,
        coll_bytes_per_chip=50e9 * 0.2,
        coll_breakdown={}, peak_mem_per_chip=8e9,
        model_flops_total=989e12 * 0.4 * 256)
    assert r.hw is R.H100
    assert r.t_compute == pytest.approx(0.5)
    assert r.t_memory == pytest.approx(0.1)
    assert r.t_collective == pytest.approx(0.2)
    assert r.dominant == "compute"
    assert r.roofline_fraction == pytest.approx(0.8)
    assert r.useful_flops_fraction == pytest.approx(0.8)
    jr = JR.RooflineResult(**{k: getattr(r, k) for k in
                              ("arch", "shape", "mesh", "chips", "flops_per_chip",
                               "bytes_per_chip", "coll_bytes_per_chip", "coll_breakdown",
                               "peak_mem_per_chip", "model_flops_total")})
    assert set(r.to_dict()) == set(jr.to_dict())


@pytest.mark.parametrize("arch", list(ARCH_IDS))
def test_model_flops_matches_jax(arch):
    for shape in SHAPES:
        got = R.model_flops(get_config(arch), shape)
        assert got == JR.model_flops(jax_config(arch), shape), shape.name


PER_RANK = textwrap.dedent("""
    import json, sys
    import torch, torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.launch.roofline import StepCounter, step_cost
    dist.init_process_group("fake", store=FakeStore(), rank=3, world_size=256)
    mesh = init_device_mesh("cpu", (16, 16), mesh_dim_names=("data", "model"))
    def placed(shape, placements):
        return distribute_tensor(torch.empty(shape, device="meta"), mesh, placements)
    x = placed((4096, 1024), (Shard(0), Replicate()))
    w = placed((1024, 8192), (Replicate(), Shard(1)))
    xr = placed((4096, 1024), (Replicate(), Replicate()))
    wr = placed((1024, 8192), (Replicate(), Replicate()))
    with StepCounter() as c:
        y = (x @ w).redistribute(mesh, (Shard(0), Replicate()))
    out = {"sharded": [c.flops, c.dot_bytes], "local": list(y.to_local().shape),
           "collectives": [[k.kind, k.group_size, k.result_bytes] for k in c.collectives],
           "replicated": list(step_cost(lambda: xr @ wr))}
    dist.destroy_process_group()
    print(json.dumps(out))
""")


def test_counter_counts_what_one_rank_holds():
    out = subprocess.run([sys.executable, "-c", PER_RANK], capture_output=True, text=True,
                         timeout=300, cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    m, k, n = 4096, 1024, 8192
    assert got["sharded"][0] == 2 * m * k * n / 256
    # the local product (256 × 1024) @ (1024 × 512) and its result, float32
    assert got["sharded"][1] == 4 * (256 * 1024 + 1024 * 512 + 256 * 512)
    assert got["replicated"] == [2 * m * k * n, 4 * (m * k + k * n + m * n)]
    # replicating the result on "model" gathers its 16 column blocks
    assert got["collectives"] == [["all-gather", 16, 4 * 256 * 512 * 16]]
    assert got["local"] == [256, n]


def _steps(arch: str):
    """{kind: ((port flops, port bytes), (JAX flops, JAX bytes))}."""
    jmodel = jax_build(jax_config(arch).reduced())
    jparams = jax_initialize(jmodel.specs(), jax.random.PRNGKey(0))
    cfg = get_config(arch).reduced()
    model = lm_params_from_jax(jax.tree.map(np.asarray, jparams), build_model(cfg, device="cpu"))
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (B, SEQ)).astype(np.int32)
    batch = {"tokens": toks}
    if cfg.frontend == "vit_stub":
        batch["image_embeds"] = rng.standard_normal(
            (B, cfg.frontend_tokens, cfg.frontend_dim)).astype(np.float32)
    if cfg.is_encdec:
        batch["frames"] = rng.standard_normal((B, SEQ // 2, cfg.frontend_dim)).astype(np.float32)
    jb, tb = jax.tree.map(jnp.asarray, batch), {k: torch.from_numpy(v) for k, v in batch.items()}

    def jcost(fn, *args):
        return JR.hlo_cost(jax.jit(fn).lower(*args).compile().as_text())

    out = {"prefill": (R.step_cost(S.build_prefill_step(cfg), model, tb),
                       jcost(JS.build_prefill_step(jmodel.cfg), jparams, jb))}
    # decode from a prefill with room for one more token
    total = SEQ + (cfg.frontend_tokens if cfg.frontend == "vit_stub" else 0)
    if cfg.is_encdec:
        _, jcaches = jmodel.prefill(jparams, jb["frames"], jb["tokens"], max_seq=total + 1)
    else:
        extra = {"image_embeds": jb["image_embeds"]} if "image_embeds" in jb else {}
        _, jcaches = jmodel.prefill(jparams, jb["tokens"], max_seq=total + 1, **extra)
    _, caches = S.build_prefill_step(cfg)(model, tb, max_seq=total + 1)
    out["decode"] = (
        R.step_cost(S.build_decode_step(cfg), model,
                    {"token": torch.zeros((B, 1), dtype=torch.int32), "caches": caches,
                     "pos": torch.tensor(total, dtype=torch.int32)}),
        jcost(JS.build_decode_step(jmodel.cfg), jparams,
              {"token": jnp.zeros((B, 1), jnp.int32), "caches": jcaches,
               "pos": jnp.int32(total)}))
    jopt, opt = jax_optimizer("sgdm", lr=LR), make_optimizer("sgdm", lr=LR)
    labelled = dict(batch, labels=toks)
    out["train"] = (
        R.step_cost(S.build_train_step(cfg, ShapeConfig("smoke", SEQ, B, "train"), opt=opt),
                    model, opt.init(group(dict(model.named_parameters()), model)), 0,
                    {k: torch.from_numpy(v) for k, v in labelled.items()}),
        jcost(JS.build_train_step(jmodel.cfg, JaxShape("smoke", SEQ, B, "train"), mesh=None,
                                  opt=jopt),
              jparams, jopt.init(jparams), 0, jax.tree.map(jnp.asarray, labelled)))
    return cfg, out


@pytest.mark.parametrize("arch", FAMILIES)
def test_step_cost_matches_jax_hlo_cost(arch):
    _, steps = _steps(arch)
    for kind, ((flops, nbytes), (jflops, jbytes)) in steps.items():
        flops_band, bytes_band = BANDS.get((arch, kind), (0.0, 0.0))
        assert abs(flops / jflops - 1) <= flops_band, (kind, flops, jflops)
        assert abs(nbytes / jbytes - 1) <= bytes_band, (kind, nbytes, jbytes)

"""Serving on the port held to the JAX package's, on the CPU.

* ``CodedLMHead.logits`` against the JAX package's ``CodedLMHead`` and the
  dense ``x @ head`` for ``tests/test_runtime.py::TestCodedLMHead``'s three
  speed vectors, at its tolerance (2e-3), and at B = 1 and B = 17 (two
  column groups of the kernel);
* ``serve`` on the JAX package's parameters (carried across by
  ``lm_params_from_jax``) returns the JAX package's token ids;
* ``python -m repro_torch.launch.serve --reduced --coded-head --device cpu``
  exits 0 for mistral-nemo-12b and for the three archs of ``chip_smoke.py``
  phase 8 (phi3.5-moe, zamba2, xlstm);
* ``chip_smoke.py``'s phase 8 runs end to end on their reduced configs on
  the CPU, with the CUDA events, synchronisation and memory calls stubbed
  and its launch-count checks (which count the card's kernels) made no-ops;
  its decode-step bound on full configs (``meta``), and its refusal to serve
  phi3.5-moe at fewer layers than it states.

The ``cuda`` twins hold the head's three launches (``mds_encode`` once,
then one ``coded_matvec`` per column group and one ``mds_decode`` a call)
against their plain versions and count them.  The JAX reference runs on
the CPU (``jax_on_cpu``).
"""

import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cuda import cuda, jax_on_cpu  # noqa: F401  (fixtures)
from repro.configs import get_config as jax_config
from repro.models import build_model as jax_build
from repro.models.params import initialize as jax_initialize
from repro.runtime import serve_loop as jserve
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_jax
from repro_torch.core.coding import pad_rows
from repro_torch.core.s2c2 import general_allocation
from repro_torch.kernels import coded_matvec as cmv
from repro_torch.kernels import ops
from repro_torch.kernels.mds_decode import mds_decode_into_plain
from repro_torch.kernels.mds_encode import mds_encode_plain
from repro_torch.launch.serve import main
from repro_torch.models import build_model
from repro_torch.runtime.serve_loop import CodedLMHead, Request, ServeConfig, serve

pytestmark = pytest.mark.usefixtures("jax_on_cpu")   # the JAX reference on the CPU

torch.set_num_threads(1)   # small shapes; leave the cores to the timing-sensitive cluster tests

TOL = 2e-3          # tests/test_runtime.py::TestCodedLMHead
SPEEDS = [np.ones(6), np.array([1, 1, 1, 1, 0.1, 0.1]), np.array([2.0, 1, 1, 0.5, 1, 1])]
D, V = 32, 96


def _head_and_x(b: int):
    rng = np.random.default_rng(0)
    head = rng.standard_normal((D, V)).astype(np.float32)
    return head, rng.standard_normal((b, D)).astype(np.float32)


@pytest.mark.parametrize("speeds", SPEEDS, ids=["even", "two-slow", "skewed"])
def test_coded_head_matches_jax_and_dense(speeds):
    head, x = _head_and_x(3)
    want = jserve.CodedLMHead(jnp.asarray(head), n=6, k=4, chunks=8).logits(jnp.asarray(x),
                                                                            speeds)
    ch = CodedLMHead(torch.as_tensor(head), n=6, k=4, chunks=8, device="cpu")
    got = ch.logits(torch.as_tensor(x), speeds)
    assert got.shape == (3, V) and ch.v_padded == V and ch.coded.shape == (6, V // 4, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got.numpy(), x.astype(np.float64) @ head, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("b", [1, 17])
def test_coded_head_at_one_and_seventeen_columns(b):
    """B = 1 (the stream design on the card) and B = 17 (16 + 1 columns: two
    coded_matvec launches on the card), with a vocabulary that needs padding."""
    rng = np.random.default_rng(b)
    head = rng.standard_normal((D, 90)).astype(np.float32)
    x = rng.standard_normal((b, D)).astype(np.float32)
    ch = CodedLMHead(torch.as_tensor(head), n=6, k=4, chunks=8, device="cpu")
    assert ch.v_padded == 96
    jh = jserve.CodedLMHead(jnp.asarray(head), n=6, k=4, chunks=8)
    for speeds in SPEEDS:
        got = ch.logits(torch.as_tensor(x), speeds).numpy()
        assert got.shape == (b, 90)
        np.testing.assert_allclose(got, np.asarray(jh.logits(jnp.asarray(x), speeds)),
                                   rtol=TOL, atol=TOL)
        np.testing.assert_allclose(got, x.astype(np.float64) @ head, rtol=TOL, atol=TOL)


def test_cpu_coded_head_launches_no_kernel():
    ops.reset_launch_counts()
    head, x = _head_and_x(2)
    CodedLMHead(torch.as_tensor(head), n=6, k=4, chunks=8, device="cpu").logits(
        torch.as_tensor(x), SPEEDS[1])
    assert ops.launch_counts() == dict.fromkeys(ops.launch_counts(), 0)


@pytest.fixture(scope="module")
def nemo(jax_on_cpu):  # noqa: F811
    jmodel = jax_build(jax_config("mistral-nemo-12b").reduced())
    jparams = jax_initialize(jmodel.specs(), jax.random.PRNGKey(0))
    return jmodel, jparams


def _requests(make, vocab: int):
    """Three prompts of unequal length (left padding), 4 new tokens each."""
    rng = np.random.default_rng(5)
    return [make(rid=i, prompt=rng.integers(1, vocab, size=n).astype(np.int32), max_new=4)
            for i, n in enumerate([5, 3, 5])]


def _port_model(nemo, device):
    cfg = get_config("mistral-nemo-12b").reduced()
    return lm_params_from_jax(jax.tree.map(np.asarray, nemo[1]), build_model(cfg, device=device))


def test_serve_matches_jax_token_ids(nemo):
    jmodel, jparams = nemo
    vocab = jmodel.cfg.vocab_size
    want = jserve.serve(jmodel, jparams, _requests(jserve.Request, vocab),
                        jserve.ServeConfig(max_batch=2))
    got = serve(_port_model(nemo, "cpu"), _requests(Request, vocab), ServeConfig(max_batch=2),
                device="cpu")
    assert got == want
    assert sorted(got) == [0, 1, 2] and all(len(v) == 4 for v in got.values())


def test_serve_refuses_a_model_on_another_device(nemo):
    with pytest.raises(ValueError, match="the model is on"):
        serve(build_model(get_config("mistral-nemo-12b").reduced(), device="meta"),
              _requests(Request, 512), ServeConfig(), device="cpu")


SERVED = ["mistral-nemo-12b", "phi3.5-moe-42b-a6.6b", "zamba2-1.2b", "xlstm-125m"]


@pytest.mark.parametrize("arch", SERVED)
def test_launch_serve_main_on_the_cpu(capsys, arch):
    assert main(["--arch", arch, "--reduced", "--coded-head", "--device", "cpu", "--requests",
                 "3", "--max-new", "4"]) == 0
    out = capsys.readouterr().out
    assert "coded lm_head rel_err=" in out and "3 requests, 12 tokens" in out
    err = float(out.split("rel_err=")[1].split()[0])
    assert err < 1e-3


def _hold_head_launches(head, x, speeds, dev):
    """One logits call with its launches counted from 0, each launch held
    against its plain version on the same tensors.  Returns the counts."""
    ops.reset_launch_counts()
    ch = CodedLMHead(head, n=6, k=4, chunks=8, device=dev)
    got = ch.logits(x, speeds)
    counts, designs = ops.launch_counts(), ops.design_counts()["coded_matvec"]
    torch.testing.assert_close(got.double(), x.double() @ head.double(), rtol=TOL, atol=TOL)
    g = torch.as_tensor(ch.code.generator, dtype=torch.float32, device=dev)
    rows = ch.coded.shape[1]
    blocks = pad_rows(head.T, 4 * 8).reshape(4, rows, -1)
    torch.testing.assert_close(ch.coded, mds_encode_plain(g, blocks), rtol=2e-4, atol=2e-4)
    begin, count, weights, responders = ch.cm.plan_tables(general_allocation(speeds, 4, 8))
    ids, gather = ch.cm.device_tables(begin, count, responders, dev)
    view, xt = ch.coded.view(-1, ch.coded.shape[2]), x.T[:, :16].contiguous()
    parts = ops.coded_matvec(view, xt, ids, rows // 8)
    torch.testing.assert_close(parts, cmv.coded_matvec_plain(view, xt, ids, rows // 8),
                               rtol=2e-4, atol=2e-4)
    flat = parts.reshape(parts.shape[0], -1)
    out = torch.empty(4, 8, flat.shape[1], device=dev)
    torch.testing.assert_close(
        ops.mds_decode_into(weights, flat, gather, out.transpose(0, 1)),
        mds_decode_into_plain(weights, flat, gather, torch.empty_like(out).transpose(0, 1)),
        rtol=2e-4, atol=2e-4)
    return counts, designs


@pytest.mark.cuda
@pytest.mark.parametrize("b,designs", [
    (2, {"stream": 0, "split": 0, "multi": 1, "general": 0}),
    (1, {"stream": 1, "split": 0, "multi": 0, "general": 0}),
    (17, {"stream": 1, "split": 0, "multi": 1, "general": 0})])
def test_cuda_coded_head_launches(cuda, b, designs):
    rng = np.random.default_rng(b)
    head = torch.as_tensor(rng.standard_normal((256, 1000)), dtype=torch.float32, device=cuda)
    x = torch.as_tensor(rng.standard_normal((b, 256)), dtype=torch.float32, device=cuda)
    counts, got = _hold_head_launches(head, x, np.array([1, 1, 0.2, 1, 1, 0.5]), cuda)
    assert got == designs
    assert counts == {"coded_matvec": sum(designs.values()), "mds_encode": 1, "mds_decode": 1,
                      "lstm_cell": 0}


@pytest.mark.cuda
def test_cuda_serve_matches_jax_token_ids(cuda, nemo):
    jmodel, jparams = nemo
    vocab = jmodel.cfg.vocab_size
    want = jserve.serve(jmodel, jparams, _requests(jserve.Request, vocab),
                        jserve.ServeConfig(max_batch=2))
    got = serve(_port_model(nemo, cuda), _requests(Request, vocab), ServeConfig(max_batch=2),
                device=cuda)
    assert got == want


@pytest.mark.cuda
@pytest.mark.parametrize("arch", SERVED)
def test_cuda_launch_serve_main(cuda, capsys, arch):
    ops.reset_launch_counts()
    assert main(["--arch", arch, "--reduced", "--coded-head", "--requests", "3",
                 "--max-new", "4"]) == 0
    assert ops.launch_counts() == {"coded_matvec": 1, "mds_encode": 1, "mds_decode": 1,
                                   "lstm_cell": 0}
    assert ops.design_counts()["coded_matvec"] == {"stream": 0, "split": 0, "multi": 1,
                                                   "general": 0}
    assert "3 requests, 12 tokens" in capsys.readouterr().out


class _Event:
    """A stand-in for ``torch.cuda.Event`` on the CPU: every span 1 ms."""

    def __init__(self, *args, **kwargs):
        pass

    def record(self):
        pass

    def synchronize(self):
        pass

    def query(self):
        return True

    def elapsed_time(self, other):
        return 1.0


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def _compare(name, got, want, tol):
    """chip_smoke's kernel-against-plain check, on the CPU."""
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=tol, atol=tol, err_msg=name)
    return float((got - want).abs().max())


def _in_turns(label, fns, order):
    """Each version once; every time 1 ms."""
    for name in order:
        fns[name]()
    return {name: {"device_ms": [1.0], "call_ms": [1.0]} for name in fns}


def test_chip_smoke_phase_eight_on_the_cpu(monkeypatch, capsys):
    """Phase 8 on the reduced configs of its eight archs: the entry point's
    coded head where it builds one (not for gemma3's tied head, not for
    nemotron, whose head (e) builds alone), (b)'s real context of 256
    tokens past the reduced window of 16, so that gemma3's local layers and
    mixtral's decode from rotating caches, internvl2's prefill with its
    image embeddings, and (c)-(e); mistral-large's (c) and (d) on a draw of
    its first F32_LAYERS layers, its untied head coded at the entry point
    and held in (e)."""
    smoke = _chip_smoke()
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *args: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *args: 0)
    monkeypatch.setattr(smoke, "device_kernel_ms", lambda fn, steps: None)
    monkeypatch.setattr(smoke, "expect", lambda *args: None)
    monkeypatch.setattr(cmv, "coded_matvec_multi", cmv.coded_matvec_plain)
    launches, records = smoke.families_phase(torch.device("cpu"), _compare, _in_turns,
                                             reduced=True)
    assert launches == dict.fromkeys(launches, 0)      # the CPU launches no kernel
    assert list(records) == ["phi3.5-moe-42b-a6.6b", "zamba2-1.2b", "xlstm-125m", "gemma3-27b",
                             "internvl2-26b", "mixtral-8x22b", "nemotron-4-340b",
                             "mistral-large-123b"]
    for arch, rec in records.items():
        assert rec["tokens"] == 48 and rec["steps"] == 32
        assert rec["f32_handoff_rel_err"] <= smoke.F32_HANDOFF_REL
        assert rec["bf16_step_rel_errs"][0] <= smoke.BF16_LOGITS_REL
        assert {"apply_norm", "head_apply"} <= set(rec["bf16_block_rel_err"])
        long = rec["long"][0]
        assert 0 < rec["step_bound_ms"] < long["step_bound_ms"] or arch == "xlstm-125m"
        if arch == "gemma3-27b":
            assert rec["coded_head_err"] is None and "head_hold_err" not in rec
        else:
            assert rec["head_hold_err"] <= smoke.REL_ERR_LIMIT
            assert set(rec["head_kernel_vs_plain"]) == {"mds_encode", "coded_matvec",
                                                        "mds_decode"}
            assert rec["head_multi_ms"] == 1.0 and rec["head_bound_by"] == "bytes"
            assert (rec["coded_head_err"] is None) == (arch == "nemotron-4-340b")
    # past the window of 16 the local layers keep 16 positions, the global the prompt's
    assert records["gemma3-27b"]["long"][0]["cache_lengths"] == {
        "local": {16: 2}, "global": {256 + smoke.LONG_STEPS + smoke.PROFILED_STEPS + 4: 2}}
    assert records["mixtral-8x22b"]["long"][0]["cache_lengths"] == {"local": {16: 4}}
    internvl = records["internvl2-26b"]
    assert internvl["long"][0]["positions"] == 256 + 8
    assert internvl["bf16_block_rel_err"]["projector"] <= smoke.BF16_REL
    for arch in ("phi3.5-moe-42b-a6.6b", "mixtral-8x22b"):
        moe = records[arch]
        assert 0 < moe["routed_share"] <= 1 and moe["routed_bound_ms"] <= moe["step_bound_ms"]
        assert moe["moe_bf16_rel_err"] <= smoke.BF16_REL
    large = records["mistral-large-123b"]
    reduced = get_config("mistral-large-123b").reduced()
    assert large["layers"] == reduced.num_layers
    assert large["f32_layers"] == min(smoke.F32_LAYERS["mistral-large-123b"], reduced.num_layers)
    assert large["coded_head_err"] <= smoke.REL_ERR_LIMIT
    assert large["long"][0]["cache_lengths"] == {
        "global": {256 + smoke.LONG_STEPS + smoke.PROFILED_STEPS + 4: reduced.num_layers}}
    out = capsys.readouterr().out
    assert out.count("6 requests, 48 tokens") == 8 and "phase 8 xlstm-125m (c)" in out
    assert out.count("(e): coded lm_head (6, 4)") == 7


def test_chip_smoke_decode_step_bound():
    """One decode step's bound on full configs (``meta``): mistral-nemo-12b
    reads its 23.2 GB of weights but the embedding (float32 norms at 4
    bytes), bytes-bound near 6.9 ms on the H100's 3.35 TB/s, and its KV
    cache grows it; phi3.5-moe's routed share of the experts shrinks it."""
    smoke = _chip_smoke()
    nemo = build_model(get_config("mistral-nemo-12b"), device="meta")
    ms, by = smoke.decode_step_bound(nemo, 4, 8)
    assert by == "bytes" and 6.8 < ms < 7.0
    assert smoke.decode_step_bound(nemo, 4, 2056)[0] > ms + 0.1
    phi = build_model(dataclasses.replace(get_config("phi3.5-moe-42b-a6.6b"), num_layers=4),
                      device="meta")
    every, half = smoke.decode_step_bound(phi, 4, 8), smoke.decode_step_bound(phi, 4, 8, 0.5)
    assert half[0] < every[0] and every[1] == "bytes"


def test_chip_smoke_refuses_a_phi_that_does_not_fit(monkeypatch):
    """Phase 8 serves phi3.5-moe at MOE_LAYERS layers or fails: it never
    shrinks the model to the memory that is free."""
    smoke = _chip_smoke()
    cfg = dataclasses.replace(get_config(smoke.MOE_ARCH), num_layers=smoke.MOE_LAYERS)
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda dev: (84 * 10**9, 85 * 10**9))
    smoke.check_fits(cfg, "cuda")
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda dev: (81 * 10**9, 85 * 10**9))
    with pytest.raises(RuntimeError, match="leaving less than 8 GiB"):
        smoke.check_fits(cfg, "cuda")

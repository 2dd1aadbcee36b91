"""Serving on the port held to the JAX package's, on the CPU.

* ``CodedLMHead.logits`` against the JAX package's ``CodedLMHead`` and the
  dense ``x @ head`` for ``tests/test_runtime.py::TestCodedLMHead``'s three
  speed vectors, at its tolerance (2e-3), and at B = 1 and B = 17 (two
  column groups of the kernel);
* ``serve`` on the JAX package's parameters (carried across by
  ``lm_params_from_jax``) returns the JAX package's token ids;
* ``python -m repro_torch.launch.serve --reduced --coded-head --device cpu``
  exits 0.

The ``cuda`` twins hold the head's three launches (``mds_encode`` once,
then one ``coded_matvec`` per column group and one ``mds_decode`` a call)
against their plain versions and count them.  The JAX reference runs on
the CPU (``jax_on_cpu``).
"""

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


def test_launch_serve_main_on_the_cpu(capsys):
    assert main(["--reduced", "--coded-head", "--device", "cpu", "--requests", "3",
                 "--max-new", "4"]) == 0
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
def test_cuda_launch_serve_main(cuda, capsys):
    ops.reset_launch_counts()
    assert main(["--reduced", "--coded-head", "--requests", "3", "--max-new", "4"]) == 0
    assert ops.launch_counts() == {"coded_matvec": 1, "mds_encode": 1, "mds_decode": 1,
                                   "lstm_cell": 0}
    assert ops.design_counts()["coded_matvec"] == {"stream": 0, "split": 0, "multi": 1,
                                                   "general": 0}
    assert "3 requests, 12 tokens" in capsys.readouterr().out

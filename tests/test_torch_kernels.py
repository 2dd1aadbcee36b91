"""The port's four kernels.

On the CPU: each plain version (what ``repro_torch.kernels.ops`` runs for a
CPU tensor) is held against the JAX package's ``ref`` oracle and its Pallas
kernel in interpret mode, on the same numpy inputs, at the shapes of
``tests/test_kernels.py``.  On a card (``cuda`` marker): each CUDA kernel
is held against its plain version on the same tensors.

Tolerances are the JAX kernel tests' own (``tests/test_kernels.py:23-24,
126-129``): float32 2e-4, since the sums run in another order; bfloat16
5e-2, since inputs and outputs round to 8 bits of mantissa; the LSTM cell
1e-5, since it sums at most a few terms.  The LSTM window (``lstm_sequence``)
keeps the cell's 1e-5 over up to 1,000 steps: its state is bounded (|h| < 1)
and, with weights at the JAX package's ``init_lstm`` scale of 1/sqrt(H), a
step damps the rounding of the steps before it instead of compounding it.
"""

import numpy as np
import pytest
import torch

from _torch_cuda import cuda  # noqa: F401  (fixture)
from repro_torch.kernels import ops, ref

torch.set_num_threads(1)   # small shapes; leave the cores to the timing-sensitive cluster tests

TOL = {"float32": dict(rtol=2e-4, atol=2e-4), "bfloat16": dict(rtol=5e-2, atol=5e-2)}
LSTM_TOL = dict(rtol=1e-5, atol=1e-5)
TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# the last: rows over 32 KB in float32, the split-row stream's shapes
MATVEC_SHAPES = [(8, 8, 128, 1), (12, 16, 300, 3), (6, 32, 512, 8), (5, 8, 130, 2),
                 (4, 3, 8200, 1)]
ENCODE_SHAPES = [(5, 3, 64, 128), (12, 10, 100, 260), (4, 4, 16, 640)]
DECODE_SHAPES = [(4, 3, 5, 128), (6, 7, 10, 200), (1, 2, 2, 512)]
# the table-addressed decode: (chunks, k, m, r, partial rows P)
DECODE_INTO_SHAPES = [(4, 3, 3, 128, 12), (20, 10, 10, 30, 200), (3, 5, 7, 37, 9)]
TABLES = ["identity", "permuted", "repeated"]
LSTM_SHAPES = [(1, 1, 4), (12, 1, 4), (100, 3, 8), (7, 2, 16)]
# the window: (T, B, I, H, O)
SEQUENCE_SHAPES = [(1, 1, 1, 4, 1), (29, 12, 1, 4, 1), (32, 12, 1, 4, 1), (10, 100, 3, 8, 2),
                   (7, 7, 2, 16, 1)]


@pytest.fixture(scope="module")
def jax_kernels():
    """The JAX package's kernel ops and oracles (absent where JAX is)."""
    pytest.importorskip("jax")
    from repro.kernels import ops as jops, ref as jref
    return jops, jref


def _rand(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _both(arr, dtype):
    """One numpy array as a torch tensor and a jax array of the same dtype
    (bfloat16 rounds the same way, to nearest even, on both sides)."""
    import jax.numpy as jnp
    t = torch.from_numpy(arr).to(TORCH_DTYPE[dtype])
    return t, jnp.asarray(t.float().numpy(), getattr(jnp, dtype))


def _np(t):
    return np.asarray(t, dtype=np.float32) if not isinstance(t, torch.Tensor) \
        else t.float().numpy()


class TestCodedMatvec:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("chunks,br,d,nvec", MATVEC_SHAPES)
    def test_plain_matches_jax(self, jax_kernels, dtype, chunks, br, d, nvec):
        import jax.numpy as jnp
        jops, jref = jax_kernels
        rng = np.random.default_rng(chunks * 1000 + d)
        a, ja = _both(_rand(rng, (chunks * br, d)), dtype)
        x, jx = _both(_rand(rng, (d, nvec)), dtype)
        ids_np = rng.choice(chunks, size=max(2, chunks // 2), replace=False).astype(np.int32)
        ids, jids = torch.from_numpy(ids_np), jnp.asarray(ids_np)
        got = ops.coded_matvec(a, x, ids, br)
        assert got.shape == (ids_np.size, br, nvec) and got.dtype == a.dtype
        np.testing.assert_allclose(_np(got), _np(jref.coded_matvec_ref(ja, jx, jids, br)),
                                   **TOL[dtype])
        np.testing.assert_allclose(_np(got), _np(jops.coded_matvec(ja, jx, jids, br)),
                                   **TOL[dtype])

    def test_vector_input(self, jax_kernels):
        import jax.numpy as jnp
        jops, _ = jax_kernels
        rng = np.random.default_rng(1)
        a_np, x_np = _rand(rng, (64, 96)), _rand(rng, (96,))
        ids_np = np.array([3, 0, 7], np.int32)
        got = ops.coded_matvec(torch.from_numpy(a_np), torch.from_numpy(x_np),
                               torch.from_numpy(ids_np), 8)
        want = jops.coded_matvec(jnp.asarray(a_np), jnp.asarray(x_np), jnp.asarray(ids_np), 8)
        assert got.shape == (3, 8)
        np.testing.assert_allclose(_np(got), _np(want), **TOL["float32"])

    @pytest.mark.parametrize("d,dtype,nvec,offset,design", [
        (2048, torch.float32, None, 0, "stream"), (2048, torch.float32, 1, 0, "stream"),
        (4096, torch.bfloat16, None, 0, "stream"), (8192, torch.float32, None, 0, "stream"),
        (16384, torch.bfloat16, None, 0, "stream"), (4, torch.float32, None, 0, "stream"),
        (130, torch.float32, None, 0, "general"), (2048, torch.float32, 3, 0, "multi"),
        (2048, torch.float32, None, 1, "general"), (8200, torch.float32, None, 0, "split"),
        (16392, torch.bfloat16, None, 0, "split"),
        # rows over 32 KB at nvec = 1 take the split-row stream where rows
        # and base are 16-byte aligned, the general path where the base is not
        (16384, torch.float32, None, 0, "split"), (32768, torch.float32, None, 0, "split"),
        (32768, torch.float32, 1, 0, "split"), (32768, torch.bfloat16, None, 0, "split"),
        (8200, torch.float32, None, 1, "general"),
        # every x of 2 to 16 columns takes the multi design, whatever d,
        # the base's alignment or the row's length
        (2048, torch.float32, 2, 0, "multi"), (2048, torch.float32, 5, 0, "multi"),
        (2048, torch.bfloat16, 8, 0, "multi"), (2048, torch.float32, 16, 0, "multi"),
        (130, torch.float32, 8, 0, "multi"), (2048, torch.float32, 8, 1, "multi"),
        (8200, torch.float32, 16, 0, "multi"), (16392, torch.bfloat16, 2, 0, "multi")])
    def test_stream_dispatch_rule(self, d, dtype, nvec, offset, design):
        """The stream design takes nvec = 1 with 16-byte-aligned rows of at
        most 32 KB, the split-row stream those over 32 KB; the multi design
        every nvec of 2 or more; the general path the rest."""
        from repro_torch.kernels import coded_matvec as cmv
        flat = torch.empty(8 * d + 16, dtype=dtype)
        shift = (-flat.data_ptr() % 16) // flat.element_size() + offset
        a = flat[shift:shift + 8 * d].view(8, d)
        x = torch.empty(d, dtype=dtype) if nvec is None else torch.empty(d, nvec, dtype=dtype)
        assert cmv.design_of(a, x) == design

    def test_work_scales_with_assignment(self):
        """Compacted output shape == number of assigned blocks (the S²C² property)."""
        a = torch.randn(64, 128)
        x = torch.randn(128, 1)
        for nb in (0, 1, 3, 8):
            out = ops.coded_matvec(a, x, torch.arange(nb, dtype=torch.int32), 8)
            assert out.shape == (nb, 8, 1)


    @pytest.mark.parametrize("d,dtype,nvec,offset,design", [
        (2048, torch.float32, None, 0, "stream"), (8192, torch.float32, None, 0, "stream"),
        (16384, torch.bfloat16, None, 0, "stream"), (8200, torch.float32, 2, 0, "multi"),
        (32768, torch.float32, 4, 0, "multi"), (8201, torch.float32, None, 0, "general"),
        (8200, torch.float32, None, 1, "general")])
    def test_split_refuses_other_shapes(self, monkeypatch, d, dtype, nvec, offset, design):
        """``coded_matvec_split`` raises, naming the design that takes the
        shape, for a stream, multi or ragged shape; nothing is launched."""
        from repro_torch.kernels import _build
        from repro_torch.kernels import coded_matvec as cmv
        monkeypatch.setattr(_build, "library", lambda: None)
        monkeypatch.setattr(_build, "kernel", lambda name: pytest.fail(f"launched {name}"))
        flat = torch.zeros(2 * d + 16, dtype=dtype)
        shift = (-flat.data_ptr() % 16) // flat.element_size() + offset
        a = flat[shift:shift + 2 * d].view(2, d)
        x = torch.zeros(d, dtype=dtype) if nvec is None else torch.zeros(d, nvec, dtype=dtype)
        with pytest.raises(ValueError, match=f"the split design does not take.*{design}"):
            cmv.coded_matvec_split(a, x, torch.zeros(1, dtype=torch.int32), 1)


class TestMDSEncode:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("n,k,rows,d", ENCODE_SHAPES)
    def test_plain_matches_jax(self, jax_kernels, dtype, n, k, rows, d):
        jops, jref = jax_kernels
        rng = np.random.default_rng(n * 100 + rows)
        g, jg = _both(_rand(rng, (n, k)), dtype)
        blocks, jblocks = _both(_rand(rng, (k, rows, d)), dtype)
        got = ops.mds_encode(g, blocks)
        assert got.shape == (n, rows, d) and got.dtype == blocks.dtype
        np.testing.assert_allclose(_np(got), _np(jref.mds_encode_ref(jg, jblocks)),
                                   **TOL[dtype])
        np.testing.assert_allclose(_np(got), _np(jops.mds_encode(jg, jblocks)), **TOL[dtype])


class TestMDSDecode:
    @pytest.mark.parametrize("chunks,k,m,r", DECODE_SHAPES)
    def test_plain_matches_jax(self, jax_kernels, chunks, k, m, r):
        import jax.numpy as jnp
        jops, jref = jax_kernels
        rng = np.random.default_rng(chunks * 10 + r)
        w_np, y_np = _rand(rng, (chunks, k, m)), _rand(rng, (chunks, m, r))
        got = ops.mds_decode(torch.from_numpy(w_np), torch.from_numpy(y_np))
        jw, jy = jnp.asarray(w_np), jnp.asarray(y_np)
        np.testing.assert_allclose(_np(got), _np(jref.mds_decode_ref(jw, jy)), **TOL["float32"])
        np.testing.assert_allclose(_np(got), _np(jops.mds_decode(jw, jy)), **TOL["float32"])

    def test_decode_inverts_encode(self):
        """Plain decode inverts plain encode through a real MDS code."""
        from repro_torch.core.coding import MDSCode
        code = MDSCode(n=6, k=4)
        blocks = torch.randn(4, 32, 64, generator=torch.Generator().manual_seed(0))
        coded = ops.mds_encode(torch.as_tensor(code.generator, dtype=torch.float32), blocks)
        workers = [5, 1, 2, 4]
        dm = torch.as_tensor(code.decode_matrix(workers), dtype=torch.float32)
        got = ops.mds_decode(dm[None], coded[workers].reshape(1, 4, -1)).reshape(4, 32, 64)
        np.testing.assert_allclose(got.numpy(), blocks.numpy(), rtol=1e-3, atol=1e-3)


def _table(kind, rng, chunks, m, n_parts):
    """(chunks, m) row numbers of the partials: each row once in order, each
    row once in a random order, or rows drawn with repeats."""
    if kind == "identity":
        return np.arange(chunks * m, dtype=np.int32).reshape(chunks, m) % n_parts
    if kind == "permuted":
        return rng.permutation(max(n_parts, chunks * m))[: chunks * m].astype(
            np.int32).reshape(chunks, m) % n_parts
    return rng.integers(0, n_parts, size=(chunks, m), dtype=np.int32)


class TestMDSDecodeInto:
    """The table-addressed, strided decode of ``CodedMatvec.apply`` against
    the JAX package's decode on the gathered partials followed by the
    swap-and-reshape of ``src/repro/core/coded_matmul.py:156-159``."""

    @pytest.mark.parametrize("kind", TABLES)
    @pytest.mark.parametrize("chunks,k,m,r,n_parts", DECODE_INTO_SHAPES)
    def test_plain_matches_jax(self, jax_kernels, kind, chunks, k, m, r, n_parts):
        import jax.numpy as jnp
        _, jref = jax_kernels
        rng = np.random.default_rng(chunks * 100 + r)
        w_np, parts_np = _rand(rng, (chunks, k, m)), _rand(rng, (n_parts, r))
        table_np = _table(kind, rng, chunks, m, n_parts)
        y = torch.full((k * chunks * r,), float("nan"))
        got = ops.mds_decode_into(torch.from_numpy(w_np), torch.from_numpy(parts_np),
                                  torch.from_numpy(table_np),
                                  y.view(k, chunks, r).transpose(0, 1))
        assert got.shape == (chunks, k, r)
        dec = jref.mds_decode_ref(jnp.asarray(w_np), jnp.asarray(parts_np[table_np]))
        want = jnp.swapaxes(dec, 0, 1).reshape(k * chunks * r)
        np.testing.assert_allclose(y.numpy(), _np(want), **TOL["float32"])

    def test_contiguous_out_is_the_jax_contract(self, jax_kernels):
        """The identity table and a contiguous out give ``mds_decode`` itself."""
        rng = np.random.default_rng(3)
        w, y = torch.from_numpy(_rand(rng, (6, 7, 10))), torch.from_numpy(_rand(rng, (6, 10, 200)))
        table = torch.arange(60, dtype=torch.int32).view(6, 10)
        got = ops.mds_decode_into(w, y.view(60, 200), table, torch.empty(6, 7, 200))
        np.testing.assert_allclose(got.numpy(), ops.mds_decode(w, y).numpy(), **TOL["float32"])


class TestLSTMCell:
    @pytest.mark.parametrize("b,i,h", LSTM_SHAPES)
    def test_plain_matches_jax(self, jax_kernels, b, i, h):
        import jax.numpy as jnp
        jops, jref = jax_kernels
        rng = np.random.default_rng(b * 10 + h)
        arrs = [_rand(rng, s) for s in [(b, i), (b, h), (b, h), (4 * h, i), (4 * h, h),
                                        (4 * h,)]]
        gh, gc = ops.lstm_cell(*(torch.from_numpy(a) for a in arrs))
        for want in (jref.lstm_cell_ref(*(jnp.asarray(a) for a in arrs)),
                     jops.lstm_cell(*(jnp.asarray(a) for a in arrs))):
            np.testing.assert_allclose(gh.numpy(), _np(want[0]), **LSTM_TOL)
            np.testing.assert_allclose(gc.numpy(), _np(want[1]), **LSTM_TOL)


    @pytest.mark.parametrize("shapes", [
        [(8, 1), (2, 4), (2, 4), (16, 1), (16, 4), (16,)],   # h and c: another batch than x
        [(2, 1), (2, 4), (8, 4), (16, 1), (16, 4), (16,)],   # c: another batch than h
        [(2, 1), (2, 4), (2, 4), (16, 2), (16, 4), (16,)],   # w_ih: another input width
        [(2, 1), (2, 4), (2, 4), (16, 1), (12, 4), (16,)],   # w_hh: another hidden width
        [(2, 1), (2, 4), (2, 4), (16, 1), (16, 4), (15,)],   # b: another gate width
    ])
    def test_cuda_wrapper_refuses_mismatched_shapes(self, monkeypatch, shapes):
        """The kernel indexes every operand by x's batch and h's width, so
        the wrapper refuses any other shape before it reaches the library."""
        from repro_torch.kernels import _build, lstm_cell

        def forbidden(name):
            raise AssertionError(f"{name} reached with mismatched shapes")
        monkeypatch.setattr(_build, "kernel", forbidden)
        with pytest.raises(ValueError, match="do not make one LSTM cell"):
            lstm_cell.lstm_cell_cuda(*(torch.zeros(s) for s in shapes))


_SEQ_OK = [(3, 2, 1), (16, 1), (16, 4), (16,), (1, 4), (1,)]   # T = 3, B = 2, I = 1, H = 4, O = 1


def _seq_shapes(**changed):
    names = ["xs", "w_ih", "w_hh", "b", "w_out", "b_out"]
    return [changed.get(n, s) for n, s in zip(names, _SEQ_OK)]


class TestLSTMSequence:
    def test_empty_window(self, monkeypatch):
        """T = 0 gives an empty ys; the CUDA wrapper launches nothing for it."""
        from repro_torch.kernels import _build, lstm_cell

        def forbidden(name):
            raise AssertionError(f"{name} reached for an empty window")
        monkeypatch.setattr(_build, "kernel", forbidden)
        args = [torch.zeros(s) for s in _seq_shapes(xs=(0, 5, 1))]
        ops.reset_launch_counts()
        for fn in (ops.lstm_sequence, lstm_cell.lstm_sequence_cuda):
            ys = fn(*args)
            assert ys.shape == (0, 5, 1) and ys.dtype == torch.float32
        assert ops.launch_counts()["lstm_cell"] == 0

    @pytest.mark.parametrize("changed", [
        dict(xs=(3, 2, 2)),                    # xs: another input width than w_ih
        dict(w_ih=(12, 1)),                    # w_ih: another gate width
        dict(w_hh=(12, 4)),                    # w_hh: another gate width than its H
        dict(b=(15,)),                         # b: another gate width
        dict(w_out=(1, 3)),                    # w_out: another hidden width
        dict(b_out=(2,)),                      # b_out: another output width
    ])
    def test_cuda_wrapper_refuses_mismatched_shapes(self, monkeypatch, changed):
        """The kernel indexes every operand by xs's (T, B, I), w_hh's H and
        w_out's O, so the wrapper refuses any other shape before it reaches
        the library."""
        from repro_torch.kernels import _build, lstm_cell

        def forbidden(name):
            raise AssertionError(f"{name} reached with mismatched shapes")
        monkeypatch.setattr(_build, "kernel", forbidden)
        with pytest.raises(ValueError, match="do not make one LSTM sequence"):
            lstm_cell.lstm_sequence_cuda(*(torch.zeros(s) for s in _seq_shapes(**changed)))

    @pytest.mark.parametrize("i,h,o", [(1, 33, 1), (17, 4, 1), (1, 4, 17)])
    def test_cuda_wrapper_refuses_what_its_registers_cannot_hold(self, monkeypatch, i, h, o):
        from repro_torch.kernels import _build, lstm_cell

        def forbidden(name):
            raise AssertionError(f"{name} reached with H = {h}, I = {i}, O = {o}")
        monkeypatch.setattr(_build, "kernel", forbidden)
        shapes = [(3, 2, i), (4 * h, i), (4 * h, h), (4 * h,), (o, h), (o,)]
        with pytest.raises(ValueError, match="keeps a gate row in registers"):
            lstm_cell.lstm_sequence_cuda(*(torch.zeros(s) for s in shapes))


class TestDispatch:
    def test_ref_names_are_the_plain_versions(self):
        from repro_torch.kernels import coded_matvec, lstm_cell, mds_decode, mds_encode
        assert ref.coded_matvec_ref is coded_matvec.coded_matvec_plain
        assert ref.mds_encode_ref is mds_encode.mds_encode_plain
        assert ref.mds_decode_ref is mds_decode.mds_decode_plain
        assert ref.lstm_cell_ref is lstm_cell.lstm_cell_plain
        assert ref.lstm_sequence_ref is lstm_cell.lstm_sequence_plain

    def test_other_devices_raise(self):
        w = torch.empty(2, 3, 3, device="meta")
        with pytest.raises(ValueError, match="no version for device"):
            ops.mds_decode(w, torch.empty(2, 3, 8, device="meta"))
        with pytest.raises(ValueError, match="several devices"):
            ops.mds_decode(torch.zeros(2, 3, 3), torch.empty(2, 3, 8, device="meta"))


# ---------------------------------------------------------------------------
# On the card: each kernel against its plain version
# ---------------------------------------------------------------------------

def _cuda_rand(gen, shape, dtype=torch.float32):
    return torch.randn(*shape, generator=gen, device="cuda").to(dtype)


# the multi design, as (blocks in a, assigned nb, br, d): the cluster's
# chunk (nb = 1 of 3,000 rows at d = 2,048, one wave of 750 items), a
# worker's whole partition (nb = 20), a ragged br of 100 rows, a ragged d
# (scalar loads) and d = 8,192 (x in slices at every width from 5 columns)
MULTI_SHAPES = [(2, 1, 3000, 2048), (20, 20, 3000, 2048), (9, 4, 100, 2048), (3, 2, 100, 130),
                (3, 2, 100, 8192)]
MULTI_NVEC = [2, 3, 5, 8, 15, 16]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("chunks,br,d,nvec", MATVEC_SHAPES + [(6, 100, 2048, 1),
                                                             (4, 64, 1024, 16)])
def test_cuda_coded_matvec(cuda, dtype, chunks, br, d, nvec):
    gen = torch.Generator(device=cuda).manual_seed(0)
    a = _cuda_rand(gen, (chunks * br, d), TORCH_DTYPE[dtype])
    x = _cuda_rand(gen, (d, nvec), TORCH_DTYPE[dtype])
    ids = torch.randperm(chunks, generator=gen, device=cuda)[: max(2, chunks // 2)]
    ids = ids.to(torch.int32)
    got = ops.coded_matvec(a, x, ids, br)
    want = ref.coded_matvec_ref(a, x, ids, br)
    torch.cuda.synchronize()
    np.testing.assert_allclose(_np(got.cpu()), _np(want.cpu()), **TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nvec", MULTI_NVEC)
@pytest.mark.parametrize("n_blocks,nb,br,d", MULTI_SHAPES)
def test_cuda_coded_matvec_multi(cuda, dtype, nvec, n_blocks, nb, br, d):
    """The multi design against the plain version; a second run gives the
    same bits (fixed sums, no atomics)."""
    from repro_torch.kernels import coded_matvec as cmv
    gen = torch.Generator(device=cuda).manual_seed(9)
    a = _cuda_rand(gen, (n_blocks * br, d), TORCH_DTYPE[dtype])
    x = _cuda_rand(gen, (d, nvec), TORCH_DTYPE[dtype])
    ids = torch.randperm(n_blocks, generator=gen, device=cuda)[:nb].to(torch.int32)
    ops.reset_launch_counts()
    got = ops.coded_matvec(a, x, ids, br)
    assert ops.design_counts()["coded_matvec"] == {"stream": 0, "split": 0, "multi": 1,
                                                   "general": 0}
    again = cmv.coded_matvec_multi(a, x, ids, br)
    want = ref.coded_matvec_ref(a, x, ids, br)
    torch.cuda.synchronize()
    assert got.shape == (nb, br, nvec) and got.dtype == a.dtype
    assert torch.equal(got, again)
    np.testing.assert_allclose(_np(got.cpu()), _np(want.cpu()), **TOL[dtype])
    ops.reset_launch_counts()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nvec", [2, 8, 16])
def test_cuda_coded_matvec_multi_bad_id_gives_nan(cuda, dtype, nvec):
    from repro_torch.kernels import coded_matvec as cmv
    a = torch.ones(5 * 9, 256, device=cuda, dtype=TORCH_DTYPE[dtype])
    x = torch.ones(256, nvec, device=cuda, dtype=TORCH_DTYPE[dtype])
    ids = torch.tensor([1, 5, -1, 4], dtype=torch.int32, device=cuda)
    out = cmv.coded_matvec_multi(a, x, ids, 9)
    torch.cuda.synchronize()
    assert torch.all(out[[0, 3]] == 256)
    assert torch.isnan(out[[1, 2]].float()).all()


@pytest.mark.cuda
@pytest.mark.parametrize("d", [2048, 130])
def test_cuda_coded_matvec_multi_misaligned_base(cuda, d):
    """A view that starts 4 bytes past a 16-byte boundary takes scalar loads."""
    from repro_torch.kernels import coded_matvec as cmv
    gen = torch.Generator(device=cuda).manual_seed(10)
    flat = _cuda_rand(gen, (6 * 50 * d + 1,))
    a, x = flat[1:].view(6 * 50, d), _cuda_rand(gen, (d, 8))
    ids = torch.tensor([4, 0, 5], dtype=torch.int32, device=cuda)
    got = cmv.coded_matvec_multi(a, x, ids, 50)
    want = ref.coded_matvec_ref(a, x, ids, 50)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **TOL["float32"])


@pytest.mark.cuda
def test_cuda_coded_matvec_bad_id_gives_nan(cuda):
    a = torch.ones(32, 64, device=cuda)
    x = torch.ones(64, device=cuda)
    out = ops.coded_matvec(a, x, torch.tensor([1, 9], dtype=torch.int32, device=cuda), 8)
    assert torch.all(out[0] == 64) and torch.isnan(out[1]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,k,rows,d", ENCODE_SHAPES + [(5, 3, 63, 130), (40, 32, 10, 8)])
def test_cuda_mds_encode(cuda, dtype, n, k, rows, d):
    gen = torch.Generator(device=cuda).manual_seed(1)
    g = _cuda_rand(gen, (n, k), TORCH_DTYPE[dtype])
    blocks = _cuda_rand(gen, (k, rows, d), TORCH_DTYPE[dtype])
    got, want = ops.mds_encode(g, blocks), ref.mds_encode_ref(g, blocks)
    np.testing.assert_allclose(_np(got.cpu()), _np(want.cpu()), **TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("chunks,k,m,r", DECODE_SHAPES + [(3, 32, 32, 1000)])
def test_cuda_mds_decode(cuda, chunks, k, m, r):
    gen = torch.Generator(device=cuda).manual_seed(2)
    w, y = _cuda_rand(gen, (chunks, k, m)), _cuda_rand(gen, (chunks, m, r))
    got, want = ops.mds_decode(w, y), ref.mds_decode_ref(w, y)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **TOL["float32"])


@pytest.mark.cuda
@pytest.mark.parametrize("b,i,h", LSTM_SHAPES)
def test_cuda_lstm_cell(cuda, b, i, h):
    gen = torch.Generator(device=cuda).manual_seed(3)
    args = [_cuda_rand(gen, s) for s in [(b, i), (b, h), (b, h), (4 * h, i), (4 * h, h),
                                         (4 * h,)]]
    (gh, gc), (wh, wc) = ops.lstm_cell(*args), ref.lstm_cell_ref(*args)
    np.testing.assert_allclose(gh.cpu().numpy(), wh.cpu().numpy(), **LSTM_TOL)
    np.testing.assert_allclose(gc.cpu().numpy(), wc.cpu().numpy(), **LSTM_TOL)


# the window on the card, beyond SEQUENCE_SHAPES: T = 256; B = 2,048 (128
# blocks); xs staged in several 16 kB chunks (T = 1,000 over 16 rows a block;
# T = 600 over 4 rows of I = 3 at H = 16); H = 1, 3 and 6 (groups of 4, 16
# and 32 lanes, some idle); H = 9 (the shared-memory path, 7 rows of 36
# threads, O = 4H); H = 32 with I = 5 (the largest buckets)
SEQUENCE_CUDA_SHAPES = SEQUENCE_SHAPES + [
    (256, 12, 1, 4, 1), (32, 2048, 1, 4, 1), (1000, 40, 1, 4, 1), (600, 9, 3, 16, 2),
    (5, 3, 1, 1, 1), (9, 13, 1, 3, 2), (20, 70, 4, 6, 5), (4, 5, 1, 9, 36), (33, 5, 5, 32, 3)]


def _sequence_args(gen, steps, b, i, h, o):
    """A window of inputs and weights at ``init_lstm``'s 1/sqrt(H) scale."""
    scale = h ** -0.5
    return [_cuda_rand(gen, (steps, b, i)), _cuda_rand(gen, (4 * h, i)) * scale,
            _cuda_rand(gen, (4 * h, h)) * scale, _cuda_rand(gen, (4 * h,)) * scale,
            _cuda_rand(gen, (o, h)) * scale, _cuda_rand(gen, (o,)) * scale]


@pytest.mark.cuda
@pytest.mark.parametrize("steps,b,i,h,o", SEQUENCE_CUDA_SHAPES)
def test_cuda_lstm_sequence(cuda, steps, b, i, h, o):
    gen = torch.Generator(device=cuda).manual_seed(8)
    args = _sequence_args(gen, steps, b, i, h, o)
    ops.reset_launch_counts()
    got = ops.lstm_sequence(*args)
    assert ops.design_counts()["lstm_cell"] == {"sequence": 1, "cell": 0}
    want = ref.lstm_sequence_ref(*args)
    torch.cuda.synchronize()
    assert got.shape == (steps, b, o)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **LSTM_TOL)
    ops.reset_launch_counts()


# the stream design: (blocks in a, assigned nb, br, d); nb = 0, 1, fewer
# than the grid's 132 blocks and many times it, br not a multiple of the
# tile's rows (64 KB tiles: 8 rows at d = 2,048 float32, 4 at 4,096, 16 at
# 1,024; twice as many in bfloat16)
STREAM_SHAPES = [(4, 0, 16, 2048), (4, 1, 37, 2048), (64, 40, 11, 4096), (600, 1500, 6, 2048),
                 (50, 300, 130, 1024)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_blocks,nb,br,d", STREAM_SHAPES)
def test_cuda_coded_matvec_stream(cuda, dtype, n_blocks, nb, br, d):
    from repro_torch.kernels import coded_matvec as cmv
    gen = torch.Generator(device=cuda).manual_seed(4)
    a = _cuda_rand(gen, (n_blocks * br, d), TORCH_DTYPE[dtype])
    x = _cuda_rand(gen, (d,), TORCH_DTYPE[dtype])
    ids = torch.randint(0, n_blocks, (nb,), generator=gen, device=cuda, dtype=torch.int32)
    ops.reset_launch_counts()
    got = cmv.coded_matvec_stream(a, x, ids, br)
    assert ops.design_counts()["coded_matvec"] == {"stream": int(nb > 0), "split": 0,
                                                   "multi": 0, "general": 0}
    want = ref.coded_matvec_ref(a, x, ids, br)
    torch.cuda.synchronize()
    assert got.shape == (nb, br) and got.dtype == a.dtype
    np.testing.assert_allclose(_np(got.cpu()), _np(want.cpu()), **TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128, 6144, 8192])
def test_cuda_coded_matvec_stream_ring_depths(cuda, d):
    """The ring's depth follows d: float32 rows of 64 and 128 columns make
    8 and 7 stages of 64 rows, of 6,144 and 8,192 columns 4 and 3 stages of
    2 rows; each gives the same product."""
    from repro_torch.kernels import coded_matvec as cmv
    gen = torch.Generator(device=cuda).manual_seed(7)
    a, x = _cuda_rand(gen, (40 * 13, d)), _cuda_rand(gen, (d,))
    ids = torch.randint(0, 40, (300,), generator=gen, device=cuda, dtype=torch.int32)
    got = cmv.coded_matvec_stream(a, x, ids, 13)
    want = ref.coded_matvec_ref(a, x, ids, 13)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **TOL["float32"])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_coded_matvec_stream_bad_id_gives_nan(cuda, dtype):
    from repro_torch.kernels import coded_matvec as cmv
    a = torch.ones(5 * 9, 256, device=cuda, dtype=TORCH_DTYPE[dtype])
    x = torch.ones(256, device=cuda, dtype=TORCH_DTYPE[dtype])
    ids = torch.tensor([1, 5, -1, 4], dtype=torch.int32, device=cuda)
    out = cmv.coded_matvec_stream(a, x, ids, 9)
    torch.cuda.synchronize()
    assert torch.all(out[[0, 3]] == 256)
    assert torch.isnan(out[[1, 2]].float()).all()


@pytest.mark.cuda
def test_cuda_coded_matvec_design_follows_shape(cuda):
    """Aligned nvec = 1 shapes take the stream, or the split-row stream for
    rows over 32 KB; several vectors the multi design; a ragged row or a
    misaligned base at nvec = 1 the general path."""
    from repro_torch.kernels import coded_matvec as cmv
    gen = torch.Generator(device=cuda).manual_seed(5)
    ids = torch.tensor([0, 2], dtype=torch.int32, device=cuda)
    flat = _cuda_rand(gen, (4 * 8 * 2048 + 1,))
    wide = _cuda_rand(gen, (32 * 8200 + 1,))
    cases = {
        "stream": [(_cuda_rand(gen, (32, 2048)), _cuda_rand(gen, (2048,))),
                   (_cuda_rand(gen, (32, 4096), torch.bfloat16),
                    _cuda_rand(gen, (4096, 1), torch.bfloat16)),
                   (_cuda_rand(gen, (32, 8192)), _cuda_rand(gen, (8192,)))],
        "multi": [(_cuda_rand(gen, (32, 2048)), _cuda_rand(gen, (2048, 3))),
                  (flat[1:].view(32, 2048), _cuda_rand(gen, (2048, 16))),
                  (_cuda_rand(gen, (32, 8200)), _cuda_rand(gen, (8200, 2)))],
        "split": [(_cuda_rand(gen, (32, 8200)), _cuda_rand(gen, (8200,))),
                  (_cuda_rand(gen, (32, 16392), torch.bfloat16),
                   _cuda_rand(gen, (16392, 1), torch.bfloat16))],
        "general": [(_cuda_rand(gen, (32, 130)), _cuda_rand(gen, (130,))),
                    (flat[1:].view(32, 2048), _cuda_rand(gen, (2048,))),
                    (wide[1:].view(32, 8200), _cuda_rand(gen, (8200,)))],
    }
    for design, operands in cases.items():
        for a, x in operands:
            ops.reset_launch_counts()
            got = ops.coded_matvec(a, x, ids, 8)
            assert cmv.design_of(a, x) == design
            assert ops.design_counts()["coded_matvec"] == {
                name: int(name == design) for name in ("stream", "split", "multi", "general")}
            np.testing.assert_allclose(_np(got.cpu()),
                                       _np(ref.coded_matvec_ref(a, x, ids, 8).cpu()),
                                       **TOL["float32" if a.dtype == torch.float32
                                             else "bfloat16"])
    with pytest.raises(ValueError, match="the stream design does not take"):
        cmv.coded_matvec_stream(a, x, ids, 8)
    with pytest.raises(ValueError, match="the split design does not take"):
        cmv.coded_matvec_split(a, x, ids, 8)
    with pytest.raises(ValueError, match="the multi design does not take"):
        cmv.coded_matvec_multi(a, x, ids, 8)
    with pytest.raises(ValueError, match="the general design does not take"):
        cmv.coded_matvec_general(*cases["multi"][0], ids, 8)
    ops.reset_launch_counts()


# the split-row stream: (d, dtype) with rows over 32 KB, cut into two slices
# (8,200 float32; 16,392 bfloat16, whose last slice is 8 columns narrower),
# and PageRank's and the filter's rows; (blocks in a, assigned nb): nb·br
# below the 132 SMs (br = 1, 3 and nb = 1, 7) and the workloads' 200 of 240
SPLIT_WIDTHS = [(8200, "float32"), (16384, "float32"), (32768, "float32"),
                (16392, "bfloat16"), (32768, "bfloat16")]
SPLIT_BLOCKS = [(9, 1), (9, 7), (240, 200)]


@pytest.mark.cuda
@pytest.mark.parametrize("d,dtype", SPLIT_WIDTHS)
@pytest.mark.parametrize("br", [1, 3, 82, 164])
@pytest.mark.parametrize("n_blocks,nb", SPLIT_BLOCKS)
def test_cuda_coded_matvec_split(cuda, d, dtype, br, n_blocks, nb):
    """The split-row stream against the plain version; one launch counted on
    the split design; a second run gives the same bits (slice sums in a
    fixed order, no atomics)."""
    from repro_torch.kernels import coded_matvec as cmv
    gen = torch.Generator(device=cuda).manual_seed(11)
    a = _cuda_rand(gen, (n_blocks * br, d), TORCH_DTYPE[dtype])
    x = _cuda_rand(gen, (d,), TORCH_DTYPE[dtype])
    ids = torch.randperm(n_blocks, generator=gen, device=cuda)[:nb].to(torch.int32)
    ops.reset_launch_counts()
    got = ops.coded_matvec(a, x, ids, br)
    assert ops.design_counts()["coded_matvec"] == {"stream": 0, "split": 1, "multi": 0,
                                                   "general": 0}
    again = cmv.coded_matvec_split(a, x, ids, br)
    want = ref.coded_matvec_ref(a, x, ids, br)
    torch.cuda.synchronize()
    assert got.shape == (nb, br) and got.dtype == a.dtype
    assert torch.equal(got, again)
    np.testing.assert_allclose(_np(got.cpu()), _np(want.cpu()), **TOL[dtype])
    ops.reset_launch_counts()


@pytest.mark.cuda
@pytest.mark.parametrize("d,dtype", [(8200, "float32"), (16392, "bfloat16")])
def test_cuda_coded_matvec_split_passes(cuda, d, dtype):
    """A block's share of more than one pass of 512 rows (2,000 blocks of 60
    rows over the SMs): the partial sums and x's slices carried from one pass
    to the next, against the plain version, with the same bits twice."""
    from repro_torch.kernels import coded_matvec as cmv
    n_blocks, nb, br = 2100, 2000, 60
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert nb * br // sms > 512
    gen = torch.Generator(device=cuda).manual_seed(13)
    a = _cuda_rand(gen, (n_blocks * br, d), TORCH_DTYPE[dtype])
    x = _cuda_rand(gen, (d,), TORCH_DTYPE[dtype])
    ids = torch.randperm(n_blocks, generator=gen, device=cuda)[:nb].to(torch.int32)
    got = cmv.coded_matvec_split(a, x, ids, br)
    again = cmv.coded_matvec_split(a, x, ids, br)
    want = ref.coded_matvec_ref(a, x, ids, br)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    np.testing.assert_allclose(_np(got.cpu()), _np(want.cpu()), **TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_coded_matvec_split_bad_id_gives_nan(cuda, dtype):
    from repro_torch.kernels import coded_matvec as cmv
    a = torch.ones(5 * 9, 16392, device=cuda, dtype=TORCH_DTYPE[dtype])
    x = torch.ones(16392, device=cuda, dtype=TORCH_DTYPE[dtype])
    ids = torch.tensor([1, 5, -1, 4], dtype=torch.int32, device=cuda)
    out = cmv.coded_matvec_split(a, x, ids, 9)
    torch.cuda.synchronize()
    assert torch.all(out[[0, 3]] == torch.tensor(16392.0).to(out.dtype))
    assert torch.isnan(out[[1, 2]].float()).all()


@pytest.mark.cuda
def test_cuda_coded_matvec_split_unaligned_x(cuda):
    """An x view off a 16-byte boundary is copied to an aligned one before
    its slices are bulk-copied."""
    from repro_torch.kernels import coded_matvec as cmv
    gen = torch.Generator(device=cuda).manual_seed(12)
    a, flat = _cuda_rand(gen, (4 * 3, 8200)), _cuda_rand(gen, (8201,))
    ids = torch.tensor([3, 1], dtype=torch.int32, device=cuda)
    got = cmv.coded_matvec_split(a, flat[1:], ids, 3)
    want = ref.coded_matvec_ref(a, flat[1:], ids, 3)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **TOL["float32"])


@pytest.mark.cuda
@pytest.mark.parametrize("kind", TABLES)
@pytest.mark.parametrize("chunks,k,m,r,n_parts", DECODE_INTO_SHAPES + [(20, 10, 10, 3000, 200),
                                                                      (7, 32, 32, 1001, 300)])
def test_cuda_mds_decode_into(cuda, kind, chunks, k, m, r, n_parts):
    gen = torch.Generator(device=cuda).manual_seed(6)
    w, parts = _cuda_rand(gen, (chunks, k, m)), _cuda_rand(gen, (n_parts, r))
    table = torch.from_numpy(_table(kind, np.random.default_rng(r), chunks, m,
                                    n_parts)).to(cuda)
    got = torch.full((k * chunks * r,), float("nan"), device=cuda)
    want = torch.full_like(got, float("nan"))
    ops.mds_decode_into(w, parts, table, got.view(k, chunks, r).transpose(0, 1))
    ref.mds_decode_into_ref(w, parts, table, want.view(k, chunks, r).transpose(0, 1))
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **TOL["float32"])


@pytest.mark.cuda
def test_cuda_mds_decode_into_bad_row_gives_nan(cuda):
    w = torch.ones(2, 3, 2, device=cuda)
    parts = torch.ones(4, 16, device=cuda)
    table = torch.tensor([[0, 1], [2, 4]], dtype=torch.int32, device=cuda)
    out = ops.mds_decode_into(w, parts, table, torch.empty(2, 3, 16, device=cuda))
    torch.cuda.synchronize()
    assert torch.all(out[0] == 2) and torch.isnan(out[1]).all()


@pytest.mark.cuda
def test_cuda_launches_are_counted(cuda):
    ops.reset_launch_counts()
    a, x = torch.randn(16, 32, device=cuda), torch.randn(32, device=cuda)
    ops.coded_matvec(a, x, torch.tensor([0, 1], dtype=torch.int32, device=cuda), 8)
    assert ops.launch_counts()["coded_matvec"] == 1
    ops.reset_launch_counts()

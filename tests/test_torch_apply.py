"""``CodedMatvec.apply``'s index tables, on the CPU.

``_index_tables`` builds the block ids with NumPy; the loop it replaced
stays here as the reference and must give the same integers.  ``apply``
packs the block ids and the (chunk, responder) positions into one int32
buffer and hands slices of it to ``coded_matvec`` and ``mds_decode_into``;
the slices must be exactly the two tables.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import coded_matmul, coding, s2c2
from repro_torch.kernels import ops

torch.set_num_threads(1)   # small shapes; leave the cores to the timing-sensitive cluster tests

CONFIGS = {"quickstart": (6, 4, 12), "main_path": (12, 10, 20), "small": (3, 2, 5)}


def _loop_block_ids(begin, count, chunks):
    return np.concatenate([w * chunks + (begin[w] + np.arange(count[w])) % chunks
                           for w in range(begin.shape[0])])


def _random_allocations(n, k, chunks, how_many, seed):
    rng = np.random.default_rng(seed)
    for _ in range(how_many):
        speeds = rng.uniform(0.05, 1.0, n)
        speeds[rng.integers(n)] = 0.0                    # one dead worker (n > k)
        yield s2c2.general_allocation(speeds, k, chunks)


@pytest.mark.parametrize("config", CONFIGS)
def test_block_ids_match_the_loop(config):
    n, k, chunks = CONFIGS[config]
    cm = coded_matmul.CodedMatvec(coding.MDSCode(n, k), chunks, device="cpu")
    for alloc in _random_allocations(n, k, chunks, 100, seed=n * 100 + chunks):
        begin, count, _, responders = cm.plan_tables(alloc)
        b, c, r = (t.numpy() for t in (begin, count, responders))
        block_ids, gather = cm._index_tables(b, c, r)
        np.testing.assert_array_equal(block_ids, _loop_block_ids(b, c, chunks))
        assert gather.shape == (chunks, k)


@pytest.mark.parametrize("config", CONFIGS)
def test_apply_hands_the_kernels_one_packed_table(config, monkeypatch):
    n, k, chunks = CONFIGS[config]
    cm = coded_matmul.CodedMatvec(coding.MDSCode(n, k), chunks, device="cpu")
    coded = cm.shard(torch.randn(chunks * k * 3, 8, generator=torch.Generator().manual_seed(0)))
    alloc = next(_random_allocations(n, k, chunks, 1, seed=1))
    tables = cm.plan_tables(alloc)
    seen = {}
    real_matvec, real_decode = ops.coded_matvec, ops.mds_decode_into

    def matvec(a, x, ids, br):
        seen["ids"] = ids
        return real_matvec(a, x, ids, br)

    def decode(w, parts, table, out):
        seen["table"] = table
        return real_decode(w, parts, table, out)

    monkeypatch.setattr(ops, "coded_matvec", matvec)
    monkeypatch.setattr(ops, "mds_decode_into", decode)
    cm.apply(coded, torch.randn(8), *tables)
    block_ids, gather = cm._index_tables(*(t.numpy() for t in (tables[0], tables[1],
                                                                 tables[3])))
    ids, table = seen["ids"], seen["table"]
    assert ids.dtype == table.dtype == torch.int32
    np.testing.assert_array_equal(ids.numpy(), block_ids)
    np.testing.assert_array_equal(table.numpy(), gather)
    # one buffer: the positions follow the block ids in the same storage
    assert table.untyped_storage().data_ptr() == ids.untyped_storage().data_ptr()
    assert table.data_ptr() == ids.data_ptr() + 4 * ids.numel()
    # the public tables, for a caller that holds one launch to its plain version
    public = cm.device_tables(tables[0], tables[1], tables[3], "cpu")
    torch.testing.assert_close(public, (ids, table), rtol=0, atol=0)


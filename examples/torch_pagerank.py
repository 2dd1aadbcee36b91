"""PageRank and n-hop graph filtering on the PyTorch/CUDA port's coded
matvec (§6.3), as ``pagerank.py`` does on the JAX package.

Power iteration with the transition matrix (n,k)-MDS-encoded once on the
device; every iteration re-plans the S²C² allocation from drifting worker
speeds and decodes the exact matvec from the assigned chunks only.

Run:  PYTHONPATH=src python examples/torch_pagerank.py [--device cpu]
"""

import argparse

import numpy as np
import torch

from repro_torch.core.coded_matmul import CodedMatvec
from repro_torch.core.coding import MDSCode
from repro_torch.core.traces import controlled_traces
from repro_torch.data.pipeline import laplacian_matrix, make_graph
from repro_torch.workloads import graph_filter, pagerank

N_WORKERS, K, CHUNKS = 12, 10, 20


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()

    n = 2400
    adj = make_graph(n, 12, seed=1)
    col = adj.sum(0, keepdims=True)
    m = adj / np.maximum(col, 1)
    m[:, col[0] == 0] = 1.0 / n

    cm = CodedMatvec(MDSCode(n=N_WORKERS, k=K), CHUNKS, device=args.device)
    coded = cm.shard(torch.as_tensor(m, dtype=torch.float32))
    traces = controlled_traces(N_WORKERS, 40, n_stragglers=2, seed=7)

    d = 0.85
    r = pagerank(cm, coded, n, 40, lambda it: traces[it], damping=d).cpu().double().numpy()
    r_ref = np.ones(n) / n
    for _ in range(40):
        r_ref = (1 - d) / n + d * (m @ r_ref)
    err = np.abs(r - r_ref).max() / r_ref.max()
    print(f"pagerank on {args.device}: 40 coded power iterations, rel_err={err:.2e}")
    top = np.argsort(-r)[:5]
    print(f"top-5 pages: {top.tolist()}")

    # n-hop graph filtering on the Laplacian (the paper's second graph app)
    lap = laplacian_matrix(adj[:1200, :1200])
    coded_l = cm.shard(torch.as_tensor(lap, dtype=torch.float32))
    x = np.random.default_rng(0).standard_normal(1200)
    got = graph_filter(cm, coded_l, torch.as_tensor(x, device=cm.device), 3,
                       lambda hop: traces[hop]).cpu().double().numpy()
    want = x.copy()
    for _ in range(3):
        want = lap @ want
    ferr = np.abs(got - want).max() / (np.abs(want).max() + 1e-12)
    print(f"3-hop Laplacian filter: rel_err={ferr:.2e}")
    assert err < 1e-4 and ferr < 1e-4
    print("OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

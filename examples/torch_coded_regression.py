"""Logistic regression and SVM by coded gradient descent (the paper's §6.3
workloads) on the PyTorch/CUDA port, with the strategies compared on
latency, as ``coded_regression.py`` does on the JAX package.

Every iteration's A·w runs through ``CodedMatvec``: the encoded matrix
stays on the device, and only the chunks Algorithm 1 assigns are computed
and decoded.  The latency comparison runs the port's simulator.

Run:  PYTHONPATH=src python examples/torch_coded_regression.py [--iters 100] [--device cpu]
"""

import argparse
import time

import torch

from repro_torch.core.coded_matmul import CodedMatvec
from repro_torch.core.coding import MDSCode
from repro_torch.core.simulation import LOCAL_CLUSTER, simulate_run
from repro_torch.core.strategies import BasicS2C2, GeneralS2C2, MDSCoded, UncodedReplication
from repro_torch.core.traces import controlled_traces
from repro_torch.data.pipeline import make_lr_dataset
from repro_torch.workloads import coded_gradient_descent

N_WORKERS, K = 12, 10


def coded_gd(loss: str, a, y, code, iters, speeds, device, lr=0.5, chunks=20):
    """Gradient descent with the A·w matvec computed under S²C²."""
    cm = CodedMatvec(code, chunks, device=device)
    a_d = torch.as_tensor(a, dtype=torch.float32, device=cm.device)
    y_d = torch.as_tensor(y, dtype=torch.float32, device=cm.device)
    w = coded_gradient_descent(cm, cm.shard(a_d), a_d, y_d, loss, iters,
                               lambda it: speeds, lr=lr).cpu().double().numpy()
    acc = ((a @ w > 0) * 2 - 1 == y).mean()
    return w, acc


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--rows", type=int, default=4000)
    ap.add_argument("--cols", type=int, default=200)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()

    a, y, _ = make_lr_dataset(rows=args.rows, cols=args.cols, seed=0)
    code = MDSCode(n=N_WORKERS, k=K)
    speeds = controlled_traces(N_WORKERS, 1, n_stragglers=1, seed=3)[0]

    for loss in ("logistic", "hinge"):
        t0 = time.time()
        w, acc = coded_gd(loss, a, y, code, args.iters, speeds, args.device)
        print(f"[{loss}] coded GD on {args.device}: {args.iters} iters in "
              f"{time.time() - t0:.1f}s, accuracy={acc:.3f}")

    # latency comparison across strategies (Fig 6 conditions)
    print("\nlatency (simulated cluster, 1 straggler, ±20% speeds):")
    tr = controlled_traces(N_WORKERS, args.iters, n_stragglers=1, seed=3)
    d_virtual = 600000
    for name, strat in (
            ("uncoded-3rep ", UncodedReplication(N_WORKERS, d_virtual)),
            ("mds-(12,10)  ", MDSCoded(N_WORKERS, K, d_virtual)),
            ("basic-s2c2   ", BasicS2C2(N_WORKERS, K, d_virtual)),
            ("general-s2c2 ", GeneralS2C2(N_WORKERS, K, d_virtual))):
        r = simulate_run(strat, tr, LOCAL_CLUSTER)
        print(f"  {name} total={r.total_time:8.2f}s  "
              f"mean_iter={r.mean_time * 1e3:7.2f}ms  "
              f"wasted_rows={r.per_worker_wasted.sum():9.0f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

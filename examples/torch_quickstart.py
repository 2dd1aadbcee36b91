"""Quickstart on the PyTorch/CUDA port: S²C² coded matvec in 40 lines.

Encodes a matrix with a (6,4)-MDS code, assigns work by predicted worker
speeds with Algorithm 1, computes only the assigned chunks, and decodes
the exact product from the partial results, as ``quickstart.py`` does on
the JAX package.  On a card, encode, compute and decode are the port's
three CUDA kernels.

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""

import argparse

import numpy as np
import torch

from repro_torch.core.coded_matmul import CodedMatvec
from repro_torch.core.coding import MDSCode
from repro_torch.core.s2c2 import general_allocation

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
args = ap.parse_args()

# 1. the data: a 1200×64 matrix, to be multiplied by x repeatedly
rng = np.random.default_rng(0)
A = torch.as_tensor(rng.standard_normal((1200, 64)), dtype=torch.float32)
x = torch.as_tensor(rng.standard_normal((64,)), dtype=torch.float32)

# 2. encode ONCE with a conservative (6,4)-MDS code -> 6 coded partitions
code = MDSCode(n=6, k=4)
chunks = 12
cm = CodedMatvec(code, chunks, device=args.device)
coded = cm.shard(A)                         # (6, 300, 64) on the device
print(f"encoded: {tuple(coded.shape)} on {coded.device} — each worker stores a "
      f"{coded.shape[1]}-row coded partition ({100 / code.k:.0f}% of the data)")

# 3. every iteration: allocate work ∝ predicted speeds (worker 4 is slow)
speeds = np.array([1.0, 1.0, 0.9, 1.0, 0.25, 0.95])
alloc = general_allocation(speeds, k=code.k, chunks=chunks)
print(f"chunks per worker: {alloc.count.tolist()}  "
      f"(coverage per chunk = {alloc.coverage().min()})")

# 4 and 5. workers compute ONLY their assigned chunk ranges, and the master
# decodes each chunk from k covering workers
y = cm.apply(coded, x.to(cm.device), *cm.plan_tables(alloc))[: A.shape[0]]

err = float((y.cpu().double() - A.double() @ x.double()).abs().max())
print(f"decode error vs direct A@x: {err:.2e}")
work_saved = 1 - alloc.count.sum() / (code.n * chunks)
print(f"work saved vs conventional (6,4)-MDS: {work_saved:.0%} "
      f"(the slack S²C² squeezed out)")
assert err < 1e-3
print("OK")

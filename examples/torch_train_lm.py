"""Train an LM with S²C²-coded data parallelism, faults, and restarts, on the
PyTorch/CUDA port.

The port of ``train_lm.py``, a thin wrapper over the training entry point
(``repro_torch.launch.train``): trains the reduced xlstm-125m config with 8
simulated DP groups, kills group 3 at step 10, checkpoints every quarter
(at least every 10 steps), and prints whether the loss improved.  A later
run with the same ``--ckpt-dir`` resumes from its last checkpoint.

Run:  PYTHONPATH=src python examples/torch_train_lm.py [--steps 60] [--device cpu]
      (the card by default; later flags override the ones below)
"""

import os
import sys
import tempfile

from repro_torch.launch.train import main as train_main

if __name__ == "__main__":
    raise SystemExit(train_main([
        "--arch", "xlstm-125m", "--reduced", "--coded-dp",
        "--groups", "8", "--tolerate", "2", "--fail-group", "3",
        "--batch", "16", "--seq", "48", "--steps", "40",
        "--ckpt-dir", os.path.join(tempfile.gettempdir(), "repro_torch_train_lm_ckpt"),
        *sys.argv[1:]]))

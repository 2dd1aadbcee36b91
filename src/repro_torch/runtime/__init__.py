"""Runtime pieces of the coded system, for PyTorch.

* :mod:`repro_torch.runtime.elastic` — §4.4 failure detection and the
  elastic re-planning around dead workers.
* :mod:`repro_torch.runtime.serve_loop` — batched LM serving and the
  S²C²-coded lm_head.
* :mod:`repro_torch.runtime.train_loop` — the fault-tolerant training loop
  with S²C²-coded data parallelism, checkpoints and restarts.

Nothing is imported here, so importing one module loads only what it needs.
"""

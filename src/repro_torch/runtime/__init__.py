"""Runtime pieces of the coded system, for PyTorch.

* :mod:`repro_torch.runtime.elastic` — §4.4 failure detection and the
  elastic re-planning around dead workers.

Nothing is imported here, so importing one module loads only what it needs.
"""

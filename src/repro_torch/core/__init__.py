"""Core S²C² coded-computing library, for PyTorch.

* :mod:`repro_torch.core.coding` — MDS generator/encode/decode algebra.
* :mod:`repro_torch.core.s2c2` — basic & general S²C² allocation (Algorithm 1).
* :mod:`repro_torch.core.coded_matmul` — the coded matvec on one device.
* :mod:`repro_torch.core.predictor` — LSTM speed forecaster, its training,
  baselines.
* :mod:`repro_torch.core.traces` — speed-trace generative model (paper §3.2).
* :mod:`repro_torch.core.simulation`, :mod:`repro_torch.core.strategies` —
  the latency simulator and the strategies it compares.
* :mod:`repro_torch.core.polynomial` — polynomial codes for Aᵀ·D·B (§5).
* :mod:`repro_torch.core.gradient_coding` — cyclic gradient codes.

Nothing is imported here, so importing one module loads only what it needs.
"""

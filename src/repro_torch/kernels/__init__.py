"""Hand-written Hopper kernels for the S²C² hot paths, with plain PyTorch versions.

* :mod:`repro_torch.kernels.coded_matvec` — assigned-blocks-only coded product.
* :mod:`repro_torch.kernels.mds_encode` — MDS encode of the data blocks.
* :mod:`repro_torch.kernels.mds_decode` — per-chunk decode contraction.
* :mod:`repro_torch.kernels.lstm_cell` — fused LSTM step of the predictor.
* :mod:`repro_torch.kernels.ops` — device dispatch; :mod:`.ref` — plain versions.

The CUDA sources are in ``csrc/`` and are built on first use (``_build``).
"""

"""The plain PyTorch version of every kernel, under the JAX package's names.

These are the semantic ground truth the kernels are held against on the
card, and what ``ops`` runs for CPU tensors.
"""

from __future__ import annotations

from repro_torch.kernels.coded_matvec import coded_matvec_plain as coded_matvec_ref
from repro_torch.kernels.lstm_cell import lstm_cell_plain as lstm_cell_ref
from repro_torch.kernels.lstm_cell import lstm_sequence_plain as lstm_sequence_ref
from repro_torch.kernels.mds_decode import mds_decode_into_plain as mds_decode_into_ref
from repro_torch.kernels.mds_decode import mds_decode_plain as mds_decode_ref
from repro_torch.kernels.mds_encode import mds_encode_plain as mds_encode_ref

__all__ = [
    "coded_matvec_ref", "mds_encode_ref", "mds_decode_ref", "mds_decode_into_ref",
    "lstm_cell_ref", "lstm_sequence_ref",
]

"""Drivers of the port, run as ``python -m repro_torch.launch.<name>``.

* :mod:`repro_torch.launch.serve` — batched serving of a decoder LM, with
  the coded lm_head's validation.
* :mod:`repro_torch.launch.train` — coded data-parallel training of any
  arch, with faults and restarts.

Nothing is imported here, so importing one module loads only what it needs.
"""

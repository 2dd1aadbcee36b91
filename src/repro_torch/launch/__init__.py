"""Drivers of the port, run as ``python -m repro_torch.launch.<name>``.

* :mod:`repro_torch.launch.serve` — batched serving of a decoder LM, with
  the coded lm_head's validation.
* :mod:`repro_torch.launch.train` — coded data-parallel training of any
  arch, with faults and restarts.
* :mod:`repro_torch.launch.mesh`, :mod:`~repro_torch.launch.partition`,
  :mod:`~repro_torch.launch.sharding` — device meshes on
  ``torch.distributed`` and the logical-axis rules that place parameters,
  batches and caches on them as DTensors.
* :mod:`repro_torch.launch.steps` — the train, prefill and decode step
  builders and each cell's abstract inputs and shardings.
* :mod:`repro_torch.launch.roofline` and :mod:`~repro_torch.launch.dryrun`
  — every (arch × shape) run once on a ``fake`` process group of the
  production meshes, counted per rank against the H100's roofline.

Nothing is imported here, so importing one module loads only what it needs.
"""

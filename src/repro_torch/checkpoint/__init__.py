"""Checkpoints of the port (:mod:`repro_torch.checkpoint.checkpoint`): the
JAX package's on-disk layout, restored in place.

Nothing is imported here, so importing one module loads only what it needs.
"""

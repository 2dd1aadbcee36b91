"""Optimizers of the port (:mod:`repro_torch.optim.optimizer`): AdamW,
Adafactor and momentum SGD on groups of tensors.

Nothing is imported here, so importing one module loads only what it needs.
"""

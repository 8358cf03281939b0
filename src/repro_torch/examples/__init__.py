"""Twins of the reference's ``examples/``, run as
``python -m repro_torch.examples.<name>``."""

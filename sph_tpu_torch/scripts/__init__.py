"""Measurement scripts of the port (counterparts of ``scripts/``), each run
as ``python -m sph_tpu_torch.scripts.<name>``."""

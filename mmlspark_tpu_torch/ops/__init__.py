"""Device ops of the port; the CUDA sources are under ``csrc/``."""

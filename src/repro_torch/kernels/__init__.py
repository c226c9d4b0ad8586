"""Paged decode kernels of the port: CUDA sources in ``csrc/``, their
plain PyTorch versions in ``ref.py``, dispatch in ``ops.py``."""

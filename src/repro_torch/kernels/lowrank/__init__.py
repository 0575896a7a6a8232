"""Batched low-rank inverse-root apply: plain version (ref.py) and CUDA
kernel wrapper (kernel.py)."""

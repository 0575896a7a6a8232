"""Batched Gram: plain version (ref.py) and CUDA kernel wrapper
(kernel.py)."""

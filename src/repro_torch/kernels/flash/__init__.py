"""Flash attention forward: plain version (ref.py), CUDA kernel wrapper
(kernel.py) and the differentiable entry point (ops.py)."""

"""Hand-written Hopper kernels of the optimizer hot path, their plain
PyTorch versions, and the device-dispatching kernel set."""

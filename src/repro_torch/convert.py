"""Parameters from the JAX package, so both packages start from identical
weights.  The JAX tree arrives as numpy arrays (``np.asarray`` of each
leaf); this module imports no JAX."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import tree
from repro_torch.models import model as model_lib
from repro_torch.models.config import ModelConfig


def params_from_numpy(cfg: ModelConfig, params: dict) -> dict:
    """The port's parameter dict (on the CPU) for a nested dict of numpy
    arrays in the reference's layout.  Keys and shapes must match
    ``param_shapes(cfg)``; values are cast exactly to ``cfg.dtype`` (bf16
    arrives as ml_dtypes bfloat16 and goes through f32, which holds every
    bf16 value)."""
    like = model_lib.param_shapes(cfg)
    if tree.structure(params) != tree.structure(like):
        raise ValueError("parameter tree keys differ from param_shapes(cfg)")
    dtype = model_lib.DTYPES[cfg.dtype]
    leaves = []
    for shape, arr in zip(tree.flatten(like), tree.flatten(params)):
        arr = np.asarray(arr)
        if tuple(arr.shape) != tuple(shape):
            raise ValueError(f"parameter of shape {arr.shape}, expected "
                             f"{shape}")
        leaves.append(torch.from_numpy(arr.astype(np.float32)).to(dtype))
    return tree.unflatten(like, leaves)

"""Helpers of the tests that hold the PyTorch port against the JAX package
(and of the card tests, which import no JAX)."""
import importlib.util
import os

import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True)
def torch_one_thread():
    """Run PyTorch's CPU ops on one thread in these tests.  Their tensors
    are tiny, and in a process that also runs XLA's CPU thread pool a
    multi-threaded PyTorch op waits on busy cores: a 6-step reduced run
    takes seconds instead of a quarter of one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def ladder(state) -> float:
    """The magnitude of a reference sketch's eigenvalue ladder: the larger
    of max|eigvals| and max|rho| (the slack scale of ``rho``)."""
    return max(float(np.abs(np.asarray(state.eigvals)).max()),
               float(np.abs(np.asarray(state.rho)).max()))


def assert_close_scaled(got, want, rtol=1e-4, atol_frac=1e-5, scale=None):
    """``rtol`` per entry, plus an absolute slack of ``atol_frac`` times
    ``scale``, by default the largest magnitude of ``want``: the packages
    use different LAPACK ``eigh``s and sum in different orders, so an entry
    that is a difference of large terms carries an error proportional to
    those terms.  Pass ``scale`` where those terms are not in ``want``
    itself (``rho`` is an eigenvalue of the ladder's Gram)."""
    want = np.asarray(want, np.float64)
    if scale is None:
        scale = float(np.abs(want).max(initial=0.0))
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=rtol,
                               atol=atol_frac * scale)


def chip_smoke():
    """chip_smoke.py at the repo's root, imported as a module (its phases
    run nothing at import)."""
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module

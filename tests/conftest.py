"""Registers the ``cuda`` marker: tests that need an NVIDIA card (they skip
without one; run them on the card with ``pytest -m cuda``)."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips on a host without one")

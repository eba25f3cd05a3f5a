"""The benchmark's CPU tests: run them with

    python -m pytest benchmark/tests --confcutdir=benchmark

so the repository's root conftest.py (which imports JAX) is never loaded.
Tests that need a CUDA card carry the `card` marker and skip here."""
import os

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; decides inside the test")
    import torch

    # the workers share the cores: one torch pool each of its share
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card)")
    return torch.device("cuda:0")

"""Markers of the tests under tests/. A test marked `card` needs a CUDA card:
it decides inside the test whether one is there and skips without it. Run
them on the card with

    python -m pytest tests/test_torch_spans.py -m card --confcutdir=tests

(--confcutdir keeps the root conftest.py, which imports JAX, out)."""


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")

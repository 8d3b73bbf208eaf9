"""Tests of the benchmark: CPU tests at tiny sizes, and tests marked
``chip`` that need a CUDA card and skip without one (run them on the card
with ``python3 -m pytest perfbench/tests -m chip``)."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA card; skipped without one")


@pytest.fixture
def card():
    """The CUDA device, or a skip when there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture
def tiny_bench(tmp_path):
    from perfbench.tests import tiny

    return tiny.bench(tmp_path)

"""Tests of the port's benchmark. CPU tests run anywhere; those marked
`card` need a CUDA device and skip without one (decided in the `cuda_card`
fixture, never at import)."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; run on the chip with "
        "`python3 -m pytest portbench/tests -m card`")


@pytest.fixture(autouse=True, scope="session")
def one_cpu_thread():
    """One intra-op thread a test process: several workers each spinning a
    full thread pool slow the tiny runs a hundredfold."""
    import torch

    torch.set_num_threads(1)


@pytest.fixture
def cuda_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"

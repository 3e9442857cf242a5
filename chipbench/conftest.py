"""Settings of the benchmark's own CPU tests (``test_chipbench_*.py``)."""
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chipbench_card: runs a cell on a CUDA card; skips without one")


@pytest.fixture(autouse=True)
def _few_threads():
    """The tiny runs gain nothing from many intra-op threads, and the suite
    runs beside other workers: two threads each, restored afterwards."""
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)

"""The benchmark's tests: on the CPU, except those marked ``gpu``, which
run on a CUDA card (``python3 -m pytest -m gpu benchmark/tests``) and
skip elsewhere."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips where there is none")


@pytest.fixture()
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"

"""Tests of the benchmark's harness. They run on the CPU at a tiny size;
a test that needs a CUDA card is marked ``gpu`` and skips inside the
``cuda`` fixture where there is none."""
import pytest

import bench_testutil  # noqa: F401  (puts the harness on the path)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skips without one")


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")

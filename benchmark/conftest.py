"""pytest settings of the benchmark's own tests (``python -m pytest benchmark/tests``).

The harness and the reference import as top-level packages from this
folder, the program from the checkout's root. Tests that need an NVIDIA
GPU take the ``card`` fixture and carry the ``card`` marker: they skip
where CUDA is missing, decided when the test runs.
"""

import os
import sys

import pytest

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
for path in (os.path.dirname(BENCH_DIR), BENCH_DIR):
    if path not in sys.path:
        sys.path.insert(0, path)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA GPU; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: runs on the card")
    return "cuda"

"""The benchmark's own tests: ``python -m pytest portbench/tests`` from
the checkout's root. They run on the CPU; a test that needs an NVIDIA GPU
takes the ``card`` fixture (and the ``card`` marker), which skips where
there is none. Whether there is a card is decided inside the fixture,
never while a module is imported."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA GPU (skips where there is none)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on an NVIDIA GPU")
    return torch.cuda.get_device_name(0)


@pytest.fixture
def root():
    return ROOT

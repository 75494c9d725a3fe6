"""The benchmark's CPU tests (python -m pytest bench_port/tests -q). The
tests marked `card` need a CUDA card and skip without one; whether there
is one is decided inside the `card` fixture, never at import."""

import pytest


def pytest_configure(config):
  config.addinivalue_line("markers", "card: needs a CUDA card")


@pytest.fixture
def card():
  import torch
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA card (the precision control turns on TF32)")
  return torch.device("cuda", 0)

"""The benchmark's CPU tests (tiny widths) and its card tests (marked
``gpu``, skipped without a card, decided inside the fixture)."""

import pytest


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)

"""The card fixture: decided inside the fixture, never at import."""

import pytest


@pytest.fixture
def card():
    """The card, or a skip: decided here, never at import."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the benchmark runs on the card")
    return "cuda"

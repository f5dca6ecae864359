import pytest


@pytest.fixture
def cuda_card():
    """The card, for the tests marked ``cuda``; they skip where none is."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)

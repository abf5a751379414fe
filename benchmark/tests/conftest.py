import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# tiny widths the CPU trains in seconds; every other key is the cell's own
TINY = {
    "mnist_ann": {"input": 8, "hidden": [5], "output": 2, "samples_per_round": 6,
                  "train_samples": 512},
    "rruff_ann": {"input": 9, "hidden": [5], "output": 2, "per_class": 300,
                  "train_samples": 512},
}


@pytest.fixture
def tiny():
    return TINY


@pytest.fixture
def card():
    """Skips the test where this machine has no CUDA card."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")

"""Helper that imports torch only inside the function that needs it."""

try:
    import numpy as np
except ImportError:
    np = None


def mean(xs):
    import torch

    return float(torch.tensor(xs, dtype=torch.float64).mean())

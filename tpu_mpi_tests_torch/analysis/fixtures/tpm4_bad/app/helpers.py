"""Helper that eagerly imports torch at module level (the hazard)."""

import torch  # expect: TPM401


def mean(xs):
    return float(torch.tensor(xs, dtype=torch.float64).mean())

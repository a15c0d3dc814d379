"""Helper of an entry that is documented to need torch."""

# this entry runs only where the card's stack is installed
import torch  # tpumt: ignore[TPM401]


def mean(xs):
    return float(torch.tensor(xs, dtype=torch.float64).mean())

"""TPM302 bad: a wall-clock epoch onto a float32 tensor (128 s steps)."""

import time

import torch


def stamp(device):
    return torch.tensor(time.time(), device=device)  # expect: TPM302


def stamps(n):
    return torch.full((n,), time.time() + 1.0)  # expect: TPM302

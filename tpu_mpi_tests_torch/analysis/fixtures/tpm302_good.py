"""TPM302 good: the epoch kept at float64, or encoded before a tensor."""

import time

import torch


def stamp(device):
    return torch.tensor(time.time(), dtype=torch.float64, device=device)


def stamp_us(device):
    return torch.tensor(int(time.time() * 1e6), device=device)

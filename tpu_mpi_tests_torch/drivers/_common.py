"""Shared driver plumbing (≅ the minimal part of
``tpu_mpi_tests/drivers/_common.py``): the argument parser every driver
starts from, the reporter, and the dtype map."""

from __future__ import annotations

import argparse

import torch

from tpu_mpi_tests_torch.device import DEVICES
from tpu_mpi_tests_torch.instrument.report import Reporter

TORCH_DTYPES = {
    "float32": torch.float32,
    "float64": torch.float64,
    "bfloat16": torch.bfloat16,
}


def base_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument(
        "--device",
        default="cuda",
        choices=DEVICES,
        help="where to run: the GPU (default; raises when none is "
        "present) or, only when asked, the CPU with the kernels' plain "
        "torch versions",
    )
    p.add_argument(
        "--dtype",
        default="float32",
        choices=list(TORCH_DTYPES),
        help="element type; the reference is float64 (MPI_DOUBLE)",
    )
    p.add_argument(
        "--jsonl",
        default=None,
        help="append JSONL records here",
    )
    return p


def torch_dtype(args) -> torch.dtype:
    return TORCH_DTYPES[args.dtype]


def make_reporter(args, rank: int = 0, size: int = 1) -> Reporter:
    return Reporter(rank=rank, size=size, jsonl_path=args.jsonl)

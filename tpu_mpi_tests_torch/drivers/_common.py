"""Shared driver plumbing (≅ the minimal part of
``tpu_mpi_tests/drivers/_common.py``): the argument parser every driver
starts from, the reporter, the dtype map and the process-grid spec."""

from __future__ import annotations

import argparse

import numpy as np
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
    p.add_argument(
        "--profile-dir",
        default=None,
        help="capture a torch.profiler trace (Chrome format) into this "
        "dir (≅ nsys -c cudaProfilerApi)",
    )
    p.add_argument(
        "--verbose", action="store_true", help="extra per-device reporting"
    )
    return p


#: the numpy dtype host arrays are built in; numpy has no bfloat16, so a
#: bfloat16 run builds them in float32 and :func:`host_tensor` rounds
NUMPY_DTYPES = {
    "float32": np.float32,
    "float64": np.float64,
    "bfloat16": np.float32,
}


def torch_dtype(args) -> torch.dtype:
    return TORCH_DTYPES[args.dtype]


def numpy_dtype(args):
    return NUMPY_DTYPES[args.dtype]


def host_tensor(a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """A host numpy array as a CPU tensor of ``dtype`` (shared memory
    when the dtypes agree)."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def make_reporter(args, rank: int = 0, size: int = 1) -> Reporter:
    return Reporter(rank=rank, size=size, jsonl_path=args.jsonl)


def parse_choice_list(spec: str, valid, what: str = "entries"):
    """Split a comma list and validate each entry against ``valid``.
    Returns the list, or None after printing an ERROR line (a copy of the
    JAX package's ``parse_choice_list``)."""
    names = [s.strip() for s in spec.split(",") if s.strip()]
    bad = [n for n in names if n not in valid]
    if bad or not names:
        print(f"ERROR unknown {what} {bad or [spec]}; "
              f"valid: {','.join(valid)}")
        return None
    return names


def parse_grid_mesh(spec: "str | None", n_dev: int):
    """Resolve a 'PX,PY' process-grid spec (or auto-factor ``n_dev`` into
    the squarest grid when None) → ``(px, py)``. Returns None after
    printing an ERROR line when the spec is malformed, non-positive, or
    does not multiply to the device count (a copy of the JAX package's
    ``parse_grid_mesh``)."""
    if spec:
        try:
            px, py = (int(v) for v in spec.split(","))
        except ValueError:
            print(f"ERROR --mesh must be 'PX,PY', got {spec!r}")
            return None
        if px < 1 or py < 1:
            print(f"ERROR --mesh factors must be positive, got {px},{py}")
            return None
    else:
        px = 1
        for cand in range(int(n_dev**0.5), 0, -1):
            if n_dev % cand == 0:
                px = cand
                break
        py = n_dev // px
    if px * py != n_dev:
        print(f"ERROR --mesh {px},{py} needs {px * py} devices, "
              f"have {n_dev}")
        return None
    return px, py

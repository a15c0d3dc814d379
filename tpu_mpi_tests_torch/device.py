"""Device selection: the card unless the caller asks for the CPU.

Nothing falls back. ``resolve_device("cuda")`` on a machine without a
usable GPU raises instead of quietly running the CPU path, so a number
measured on the CPU can never be reported as a device number.
"""

from __future__ import annotations

import torch

from tpu_mpi_tests_torch.utils import TpuMtError

DEVICES = ("cuda", "cpu")


def resolve_device(device: "str | torch.device | None" = "cuda"
                   ) -> torch.device:
    """``"cuda"`` (the default) → the current CUDA device, raising when
    none is available; ``"cpu"`` → the CPU, only when asked for."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise TpuMtError(
                "device 'cuda' requested but torch.cuda.is_available() is "
                "False (no GPU, or a CPU-only torch build); pass "
                "--device cpu to run the plain-torch path on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if dev.type == "cpu":
        return dev
    raise TpuMtError(f"unsupported device {device!r}; valid: {DEVICES}")

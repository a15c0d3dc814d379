"""Build and load the hand-written CUDA kernels.

Each ``csrc/*.cu`` source becomes its own shared library with a plain C
interface, compiled by ``nvcc`` for ``sm_90a`` and loaded with
``ctypes``. Builds happen at first use into ``build/torch_kernels/`` at
the repository root (listed in ``.gitignore``), one ``nvcc`` process per
source, all started together. A library's file name carries a hash of
its sources and flags, so an edited source is rebuilt and never loaded
stale; a finished library is moved into place atomically, so concurrent
processes never load a half-written file.

Nothing here runs at import time: the CPU tests import every module of
the port on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"

#: library name → its ``.cu`` source (headers in csrc/ are hashed too)
SOURCES = {
    "stencil_iterate": "stencil_iterate.cu",
    "stencil_deriv": "stencil_deriv.cu",
    "heat2d": "heat2d.cu",
    "dual_dim_step": "dual_dim_step.cu",
    "alu_probe": "alu_probe.cu",
    "pack": "pack.cu",
    "streams": "streams.cu",
    "flash_attention": "flash_attention.cu",
    "ring_halo": "ring_halo.cu",
    "fused_rdma": "fused_rdma.cu",
    "ring_collectives": "ring_collectives.cu",
    "oneshot": "oneshot.cu",
    "fused_ring_attention": "fused_ring_attention.cu",
}

# -fmad=false: no mul+add contraction anywhere, so float results match
# the plain PyTorch version bit for bit (the kernels also use the _rn
# intrinsics, which are never contracted). The flash kernel's dot
# products ask for fmaf explicitly and are held to a tolerance instead.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false", "-Xptxas", "-v",
    "-shared", "-Xcompiler", "-fPIC",
)

#: flags of one library beside NVCC_FLAGS: the k-step kernels' regs
#: route holds up to eight stages of register windows, and the probe's
#: cluster route a thread's rows, and at ptxas's default register-usage
#: level a few instances trade registers for spills; level 0 lets each
#: take the registers it needs
KSTEP_PTXAS = ("-Xptxas", "--register-usage-level=0")
LIBRARY_FLAGS = {"stencil_iterate": KSTEP_PTXAS, "fused_rdma": KSTEP_PTXAS,
                 "alu_probe": KSTEP_PTXAS}

_LOADED: dict[str, ctypes.CDLL] = {}
#: ptxas reports (registers, shared memory, spills) of this process's builds
BUILD_LOGS: dict[str, str] = {}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source."""


def nvcc_path() -> str:
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise KernelBuildError(
            "nvcc not found (set CUDA_HOME or put nvcc on PATH); the hand "
            "kernels are compiled from kernels/csrc/ at first use"
        )
    return found


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS
                                + LIBRARY_FLAGS.get(name, ())).encode())
    src = CSRC / SOURCES[name]
    for p in [src] + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}_{_digest(name)}.so"


def build(names=None) -> dict[str, Path]:
    """Compile every stale library in ``names`` (default: all) in
    parallel and return name → path. Raises :class:`KernelBuildError`
    with nvcc's output when a compile fails."""
    names = list(SOURCES) if names is None else list(names)
    paths = {n: library_path(n) for n in names}
    stale = [n for n in names if not paths[n].exists()]
    if not stale:
        return paths
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n in stale:
        fd, tmp = tempfile.mkstemp(prefix=f"lib{n}.", suffix=".so.tmp",
                                   dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, *LIBRARY_FLAGS.get(n, ()), "-I",
               str(CSRC), "-o", tmp, str(CSRC / SOURCES[n])]
        procs[n] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
        ))
    failed = []
    for n, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        BUILD_LOGS[n] = out
        if proc.returncode == 0:
            os.replace(tmp, paths[n])
        else:
            Path(tmp).unlink(missing_ok=True)
            failed.append(f"--- {SOURCES[n]} (nvcc rc={proc.returncode})\n"
                          f"{out}")
    if failed:
        raise KernelBuildError("kernel build failed:\n" + "\n".join(failed))
    return paths


def ptxas_summary(name: str, name_of=lambda mangled: mangled) -> dict:
    """Registers, stack and spill bytes of every kernel instance in this
    process's build of library ``name`` (its ``-Xptxas -v`` report in
    :data:`BUILD_LOGS`), keyed by ``name_of(mangled entry name)``."""
    out, entry = {}, None
    for line in BUILD_LOGS.get(name, "").splitlines():
        if m := re.search(r"Compiling entry function '([^']+)'", line):
            entry = name_of(m[1])
            out[entry] = {}
        elif not entry:
            continue
        elif m := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                            r"stores, (\d+) bytes spill loads", line):
            out[entry].update(stack=int(m[1]), spill_stores=int(m[2]),
                              spill_loads=int(m[3]))
        elif m := re.search(r"Used (\d+) registers", line):
            out[entry]["registers"] = int(m[1])
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name]))
        _LOADED[name] = lib
    return lib

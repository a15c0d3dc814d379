"""Trace ranges and profiler gating (≅ ``tpu_mpi_tests/instrument/trace.py``).

NVTX named ranges (``daxpy_nvtx.cu:72-91``, ``mpi_daxpy_nvtx.cc:177-325``)
become ``torch.profiler.record_function`` ranges (seen in a
``torch.profiler`` trace) plus, once the process runs on the card,
``torch.cuda.nvtx`` ranges of the same names (seen by an NVTX-aware
profiler, as the reference's were). ``cudaProfilerStart/Stop`` gating of
the capture (``summit/run.sh:15-19``) becomes a ``torch.profiler.profile``
session that writes a Chrome trace into the chosen directory on stop.
"""

from __future__ import annotations

import contextlib
import os

import torch


@contextlib.contextmanager
def trace_range(name: str):
    """Named range (≅ nvtxRangePushA/Pop): a profiler range, and an NVTX
    range too once this process has initialised CUDA."""
    with contextlib.ExitStack() as stack:
        stack.enter_context(torch.profiler.record_function(name))
        if torch.cuda.is_initialized():
            stack.enter_context(torch.cuda.nvtx.range(name))
        yield


class ProfilerGate:
    """Capture gating (≅ cudaProfilerStart/Stop with
    ``nsys profile -c cudaProfilerApi``): a ``torch.profiler`` session
    over the CPU, and the card's kernels when CUDA is initialised, that
    writes ``trace_<pid>.json`` (Chrome trace format) into ``logdir`` on
    stop. A no-op without a ``logdir``, so drivers leave the calls in
    unconditionally, as the reference leaves NVTX in every build."""

    def __init__(self, logdir: str | None = None):
        self.logdir = logdir
        self._prof = None

    @property
    def active(self) -> bool:
        return self._prof is not None

    def start(self):
        if self.logdir and self._prof is None:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_initialized():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.__enter__()

    def stop(self):
        if self._prof is None:
            return
        prof, self._prof = self._prof, None
        prof.__exit__(None, None, None)
        os.makedirs(self.logdir, exist_ok=True)
        prof.export_chrome_trace(
            os.path.join(self.logdir, f"trace_{os.getpid()}.json"))

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()
        return False

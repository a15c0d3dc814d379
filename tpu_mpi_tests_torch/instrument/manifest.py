"""Run manifest: every result file says what produced it (≅
``tpu_mpi_tests/instrument/manifest.py``).

The manifest is the first JSONL record of every run with a sink
(``kind: "manifest"``) plus a rank-0 banner line: the card, the world,
the torch and CUDA versions, the relevant environment, argv and the git
sha. :func:`topo_record` is the ``topo`` record written after it, and
:func:`clock_sync_record` the ``clock_sync`` record that lets the
per-rank files merge onto one time axis.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
from pathlib import Path

import torch

#: environment prefixes worth capturing: the framework's own knobs and
#: the torch, NCCL and CUDA switches that change what the numbers mean
ENV_PREFIXES = ("TPU_MPI_", "TORCH_", "PYTORCH_", "NCCL_", "CUDA_")


def _git_sha() -> str | None:
    """Short sha of the source tree, or None; never raises."""
    try:
        out = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            cwd=Path(__file__).resolve().parent, capture_output=True,
            text=True, timeout=5)
    except (subprocess.SubprocessError, FileNotFoundError, OSError):
        return None
    sha = out.stdout.strip()
    return sha if out.returncode == 0 and sha else None


def _device(device) -> torch.device:
    from tpu_mpi_tests_torch.comm import dist

    return torch.device(device) if device is not None else dist.world().device


def run_manifest(device=None, argv: list[str] | None = None,
                 **extra) -> dict:
    """The manifest record of this process, after the world is joined
    (``comm.mesh.bootstrap``). ``device`` defaults to the world's;
    ``extra`` is merged in. Topology fields (``hosts``,
    ``ranks_per_host``, ``topology``) are stamped only when the run's
    map is not flat (``comm/topology.py``), as in the JAX record."""
    import platform as _platform
    import socket

    from tpu_mpi_tests_torch.comm import dist
    from tpu_mpi_tests_torch.instrument.memwatch import device_memory_stats

    dev = _device(device)
    w = dist.world()
    on_card = dev.type == "cuda"
    record = {
        "kind": "manifest",
        "time_unix": time.time(),
        "time_iso": time.strftime("%Y-%m-%dT%H:%M:%S%z"),
        "argv": list(sys.argv if argv is None else argv),
        "hostname": socket.gethostname(),
        "python": _platform.python_version(),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "process_index": w.rank,
        "process_count": w.size,
        "local_device_count": w.ranks_per_host,
        # one card a rank
        "global_device_count": w.size,
        "platform": "gpu" if on_card else "cpu",
        "device_kinds": [torch.cuda.get_device_name(dev) if on_card
                         else "cpu"],
        "env": {k: v for k, v in sorted(os.environ.items())
                if k.startswith(ENV_PREFIXES)},
        "git_sha": _git_sha(),
    }
    # whether the allocator reports watermarks (the CPU does not, and
    # consumers degrade to census-only) and the card's capacity
    stats = device_memory_stats(dev)
    record["memory_stats_available"] = bool(stats)
    limits = [s["bytes_limit"] for s in stats.values() if "bytes_limit" in s]
    if limits:
        record["hbm_bytes_limit"] = max(limits)
    # the host shape (comm/topology.py), stamped only when not flat
    from tpu_mpi_tests_torch.comm.topology import current as _topology

    topo = _topology()
    if not topo.is_flat:
        record["hosts"] = topo.num_hosts
        if topo.ranks_per_host:
            record["ranks_per_host"] = topo.ranks_per_host
        record["topology"] = topo.label()
    record.update(extra)
    return record


def topo_record() -> dict:
    """The ``kind: "topo"`` record after the manifest:
    ``comm.topology.topo_record`` of the joined world (the JAX record's
    fields: a one-host world is a discovered map with its ``hosts``,
    ``ranks_per_host``, ``host_by_rank`` and, at world >= 2,
    ``link_classes``)."""
    from tpu_mpi_tests_torch.comm import topology

    return topology.topo_record()


def clock_sync_record(rounds: int = 5) -> dict:
    """This rank's wall-clock offset from rank 0 (``kind:
    "clock_sync"``), so per-rank JSONL merges onto one time axis.

    The barrier-echo handshake of the JAX function over the gloo host
    group: each round every rank leaves a barrier, reads ``time.time()``
    and all-gathers the reading (float64 travels exactly over gloo);
    ``t_local − t_rank0`` samples the offset plus the barrier's skew.
    The median of ``rounds`` samples is the estimate and their spread
    its bound (``spread_s``). One process records offset 0. Never
    raises: a world where the handshake cannot run records offset 0 as
    ``method: "unavailable: ..."``."""
    import torch.distributed as tdist

    from tpu_mpi_tests_torch.comm import dist

    w = dist.world()
    now = time.time()
    rec = {
        "kind": "clock_sync",
        "rank": w.rank,
        "process_index": w.rank,
        "process_count": w.size,
        "offset_s": 0.0,
        "spread_s": 0.0,
        "rounds": 0,
        "method": "single_process",
        "time_unix": now,
        # run identity: rank 0's first-barrier time, the same on every
        # rank of one run (the --trace-out merge's stale-file filter)
        "run_sync_us": int(round(now * 1e6)),
    }
    if w.size <= 1:
        return rec
    # The only raisers below are environmental (the host group, the
    # backend), the same on every rank, so the handler's skip is
    # symmetric, not a partner mismatch.
    try:  # tpumt: ignore[TPM1703]
        group = dist.cpu_group()
        samples = []
        run_sync_us = None
        for _ in range(rounds):
            tdist.barrier(group=group)
            t_local = time.time()
            got = [torch.zeros(1, dtype=torch.float64) for _ in range(w.size)]
            tdist.all_gather(got, torch.tensor([t_local],
                                               dtype=torch.float64),
                             group=group)
            t_rank0 = float(got[0][0])
            if run_sync_us is None:
                run_sync_us = int(round(t_rank0 * 1e6))
            samples.append(t_local - t_rank0)
        samples.sort()
        rec.update(offset_s=samples[len(samples) // 2],
                   spread_s=samples[-1] - samples[0], rounds=len(samples),
                   method="barrier_echo", run_sync_us=run_sync_us)
    except Exception as e:  # a diagnostic record, not control
        rec.update(method=f"unavailable: {type(e).__name__}",
                   run_sync_us=None)
    return rec


def manifest_banner(m: dict) -> str:
    """One-line run identity for the rank-0 banner."""
    kinds = ",".join(m.get("device_kinds", [])) or "?"
    sha = m.get("git_sha") or "unknown"
    return (
        f"MANIFEST {m.get('platform', '?')}x{m.get('global_device_count', 0)}"
        f" ({kinds}) proc {m.get('process_index', 0)}/"
        f"{m.get('process_count', 1)} torch={m.get('torch', '?')} "
        f"cuda={m.get('cuda') or '-'} git={sha}"
    )

"""Shared driver plumbing (≅ part of ``tpu_mpi_tests/drivers/_common.py``):
the argument parser every driver starts from (with the schedule plane's
``--tune``, ``--tune-cache``, ``--tune-pack`` and ``--tune-budget``), the
reporter (which configures the schedule cache and points its records at
the run's JSONL), ``--kernel auto``'s resolution, the dtype map and the
process-grid spec."""

from __future__ import annotations

import argparse
import json
import os
import sys

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
    p.add_argument(
        "--tune",
        action="store_true",
        help="arm the measured autotuner: a knob with no cache entry for "
        "this configuration runs a candidate sweep on the device and "
        "stores the winner; without it cached winners still apply and a "
        "miss takes the shipped prior (tune/priors.py)",
    )
    p.add_argument(
        "--tune-cache",
        default=None,
        metavar="PATH",
        help="schedule cache file (default: $TPU_MPI_TUNE_CACHE, else "
        "~/.cache/tpumt/tune.json); a corrupt or stale file gives the "
        "priors",
    )
    p.add_argument(
        "--tune-pack",
        default=None,
        metavar="PACK",
        help="preload a schedule pack (python -m "
        "tpu_mpi_tests_torch.tune.pack) into the in-memory cache before "
        "any knob resolves; fingerprints still decide which entries "
        "apply, and a corrupt pack degrades to empty",
    )
    p.add_argument(
        "--tune-budget",
        type=float,
        default=60.0,
        metavar="S",
        help="wall-clock budget of a sweep in seconds: the prior is always "
        "measured, later candidates are dropped (and reported as skipped) "
        "once it is spent (default 60)",
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


def make_reporter(args, rank: "int | None" = None,
                  size: "int | None" = None) -> Reporter:
    """The run's reporter; ``rank`` and ``size`` default to this process's
    place in the world (``comm.dist``); drivers emulating logical ranks in
    one process pass their own."""
    from tpu_mpi_tests_torch.comm import dist

    w = dist.world()
    rep = Reporter(rank=w.rank if rank is None else rank,
                   size=w.size if size is None else size,
                   jsonl_path=args.jsonl)
    setup_tuning(args)
    _attach_tune_sink(rep)
    return rep


def setup_tuning(args) -> None:
    """Configure the schedule cache for this run (≅ JAX
    ``_common.py:541-610``). It loads when the run asked for tuning
    (``--tune`` / ``--tune-cache`` / ``--tune-pack``) or the cache file
    exists; otherwise the registry is left unconfigured and every knob
    resolves to its prior. A ``--tune-pack`` is absorbed into the
    in-memory cache (newer measurement wins). Called after the world is
    joined, so every rank but 0 gets a read-only cache."""
    from tpu_mpi_tests_torch.tune import cache as tc
    from tpu_mpi_tests_torch.tune import registry as tr

    tr.deconfigure()
    path = getattr(args, "tune_cache", None) or tc.default_cache_path()
    pack_path = getattr(args, "tune_pack", None)
    wants = (getattr(args, "tune", False)
             or getattr(args, "tune_cache", None) or pack_path)
    if not wants and not os.path.exists(path):
        return
    cache = tr.configure(
        cache_path=path,
        enabled=getattr(args, "tune", False),
        budget_s=getattr(args, "tune_budget", None),
    )
    if pack_path:
        from tpu_mpi_tests_torch.tune import pack as tp

        doc = tp.load_pack(pack_path)
        if not doc["entries"]:
            print(f"NOTE --tune-pack {pack_path}: empty or unreadable "
                  f"pack; resolving from the local cache/priors")
        else:
            n = tp.absorb(cache, doc)
            print(f"TUNE PACK {pack_path}: {n} of "
                  f"{len(doc['entries'])} schedule entries preloaded")
        _check_pack_topology(pack_path, doc)


def _check_pack_topology(pack_path: str, doc: dict) -> None:
    """NOTE a ``--tune-pack`` measured on another topology (≅ JAX
    ``_check_pack_topology``): its entries can never resolve here."""
    from tpu_mpi_tests_torch.tune import pack as tp
    from tpu_mpi_tests_torch.tune.fingerprint import topology_label

    packed = tp.provenance(doc.get("entries") or {}).get("topologies") or []
    live = topology_label()
    if packed and live not in packed:
        decline_note(
            f"--tune-pack {pack_path}: pack topology {','.join(packed)} "
            f"does not match this run's {live}; its schedule entries will "
            f"not resolve here"
        )


def _attach_tune_sink(rep: Reporter) -> None:
    """Point the sweep records at this run's reporter (≅ JAX
    ``_attach_tune_sink``): every ``tune`` / ``tune_result`` /
    ``tune_hit`` record goes to the JSONL stream, stamped with the
    process's rank, and winners and hits get a ``TUNE`` line."""
    from tpu_mpi_tests_torch.tune import fleet
    from tpu_mpi_tests_torch.tune import registry as tr

    tr.mark_fleet_rank()
    if tr.configured_cache() is None:
        return

    def emit(rec):
        rep.jsonl({**rec, "rank": fleet.process_index()})
        kind = rec.get("kind")
        if kind == "tune_result":
            sec = rec.get("seconds")
            rep.line(
                f"TUNE {rec['knob']} winner={json.dumps(rec['value'])} "
                f"seconds={'-' if sec is None else f'{sec:.6g}'} "
                f"measured={rec.get('measured', 0)} "
                f"skipped={rec.get('skipped', 0)}"
            )
        elif kind == "tune_hit":
            rep.line(
                f"TUNE {rec['knob']} cache-hit "
                f"value={json.dumps(rec['value'])}"
            )

    tr.set_emit(emit)


def resolve_kernel_auto(dtype: str, n: int, world: int, rep) -> str:
    """``--kernel auto`` (≅ JAX ``resolve_kernel_auto``): the
    ``stencil/tier`` resolution mapped onto a driver's update body — the
    ``xla`` tier keeps the torch-op body (``torch``), every hand tier
    maps to the hand kernel (``hand``). The resolution is NOTE'd."""
    from tpu_mpi_tests_torch.comm.halo import resolve_stencil_tier

    tier = resolve_stencil_tier(None, dtype=dtype, n=n, world=world)
    kernel = "torch" if tier == "xla" else "hand"
    rep.line(f"NOTE --kernel auto -> {kernel} (stencil/tier {tier})")
    return kernel


def decline_note(msg: str) -> None:
    """Print a schedule-decline ``NOTE`` to stderr, flushed (the JAX
    package's ``decline_note``): a requested schedule cannot run here and
    another runs instead. Callers pass the message without the prefix."""
    print(f"NOTE {msg}", file=sys.stderr, flush=True)


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

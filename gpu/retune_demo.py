"""Induced-drift serving demo of the port: the closed tuning loop in one
run on the card (≅ ``tpu/retune_demo.py``).

Replaces the ``daxpy`` serve handler with one keyed on the resolved
``daxpy/chunk`` schedule: each batch runs the spec's own handler on the
card (``k`` DAXPY steps on persistent buffers), and a handler built at
the seeded winner (chunk 1) silently degrades after ``--drift-after``
batches — the schedule went stale under the tuned winner — while every
other candidate stays fast. Everything downstream is the real stack: the
metrics tee latches ``tune_stale`` when the class's achieved rate sags
below the winner's own baseline; with ``--retune`` the serve loop's
controller re-sweeps between windows, hot-swaps the handler (a
``kind: "control" event: "tune_swap"`` record) and the SLO windows
recover; without it the run limps to its end and the JAX
``tpumt-doctor`` convicts ``stale_schedule`` from the JSONL.

Before the serve run starts, the script seeds ``daxpy/chunk = 1`` into
the ``--tune-cache`` file under this device's fingerprint (the pre-seeded
winner the JAX demo warms in beforehand)::

    python gpu/retune_demo.py [--drift-after=N] <drivers/serve.py args...>

e.g. ``--duration 8 --arrival closed --concurrency 1 --seed 5
--report-interval 1 --workloads daxpy:67108864:float32 --telemetry
--retune --batch-deadline 30 --tune-cache T.json --jsonl S.jsonl``.
Every argument after the optional ``--drift-after=N`` goes to the serve
driver as it is.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

#: the drifted winner's added service time a batch, and a healthy one's
SLOW_S = 0.03
FAST_S = 0.001
#: the winner the run starts from
SEEDED_CHUNK = 1


def seed_winner(device: str, cache_path: str) -> None:
    """Store ``daxpy/chunk = SEEDED_CHUNK`` under this device's
    fingerprint in ``cache_path`` (the world joined first: the
    fingerprint names the device)."""
    from tpu_mpi_tests_torch.comm import dist
    from tpu_mpi_tests_torch.tune.cache import ScheduleCache
    from tpu_mpi_tests_torch.tune.fingerprint import device_fingerprint

    dist.init(device)
    cache = ScheduleCache(cache_path)
    cache.store("daxpy/chunk", device_fingerprint(), SEEDED_CHUNK)
    cache.save()


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    drift_after = 40
    if argv and argv[0].startswith("--drift-after="):
        drift_after = int(argv.pop(0).split("=", 1)[1])
    known = argparse.ArgumentParser(add_help=False)
    known.add_argument("--device", default="cuda")
    known.add_argument("--tune-cache", default=None)
    pre, _ = known.parse_known_args(argv)
    if pre.tune_cache:
        seed_winner(pre.device, pre.tune_cache)

    from tpu_mpi_tests_torch.drivers import _common
    from tpu_mpi_tests_torch.tune.sweep import ensure_tuned

    calls = {"n": 0}

    def drifting_daxpy_factory(device, shape, dtype):
        """The registry's contract: ``step(k)`` runs ``k`` DAXPY steps on
        the card and returns once they finished, plus the drift's delay
        where the handler was built at the seeded winner; it carries the
        ``tune_info`` recipe the ``--retune`` controller rebuilds
        through."""
        # imported here: the spec module registers its own factory
        from tpu_mpi_tests_torch.workloads.daxpy import SPEC

        real = SPEC.serve_factory(device, shape, dtype)

        def build(value=None):
            # explicit > cached > prior, through the real resolver: the
            # cache hit is what arms the metrics plane's stale watch
            eff = int(ensure_tuned("daxpy/chunk", lambda c: 0.0,
                                   explicit=value))

            def step(k: int):
                calls["n"] += 1
                out = real(k)
                drifted = eff == SEEDED_CHUNK and calls["n"] > drift_after
                time.sleep(SLOW_S if drifted else FAST_S)
                return out

            step.tune_info = {"knob": "daxpy/chunk", "ctx": {},
                              "candidates": (1, 8, 32), "rebuild": build}
            return step

        return build()

    # registered first: register_workload keeps the first factory of a
    # name, so the spec's own never displaces the drifting one here
    _common.register_workload("daxpy", drifting_daxpy_factory)
    from tpu_mpi_tests_torch.drivers import serve

    return serve.main(argv)


if __name__ == "__main__":
    sys.exit(main())

"""The schedule plane (≅ ``tpu_mpi_tests/tune/``): a measured autotuner
and a persistent schedule cache for the hot path's knobs.

* :mod:`~tpu_mpi_tests_torch.tune.priors` — the card's measured
  schedules, the cold-start priors;
* :mod:`~tpu_mpi_tests_torch.tune.fingerprint` — the cache key (the
  device's name, platform, ranks, processes, hosts, dtype, shape
  bucket);
* :mod:`~tpu_mpi_tests_torch.tune.cache` — the JSON cache file
  (``~/.cache/tpumt/tune.json``, ``TPU_MPI_TUNE_CACHE``,
  ``--tune-cache``);
* :mod:`~tpu_mpi_tests_torch.tune.registry` — the spaces (declared where
  each knob lives) and the resolution state: explicit > cached > prior;
* :mod:`~tpu_mpi_tests_torch.tune.sweep` — the measured sweep, its
  budget and its ``tune`` / ``tune_result`` / ``tune_hit`` records;
* :mod:`~tpu_mpi_tests_torch.tune.fleet` — rank 0's decisions broadcast
  to every process;
* :mod:`~tpu_mpi_tests_torch.tune.pack` — portable schedule packs
  (``python -m tpu_mpi_tests_torch.tune.pack``).

The JAX package's ``tune/controller.py`` (the serve loop's re-tuner)
comes with ``serve/`` (ROADMAP queue 1 #19).
"""

from tpu_mpi_tests_torch.tune.registry import (  # noqa: F401
    configure,
    configured_cache,
    declare_space,
    lookup,
    resolve,
    space,
    spaces,
    tuning_enabled,
)
from tpu_mpi_tests_torch.tune.sweep import ensure_tuned, sweep  # noqa: F401

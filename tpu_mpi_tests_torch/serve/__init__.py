"""The serving plane (≅ ``tpu_mpi_tests/serve/``). So far only its
bounded-memory latency histogram (``histogram.py``), which the live
metrics registry (``instrument/metrics.py``) builds its rolling windows
from; the serve loop, its traffic and its replay are ROADMAP queue 1
#19."""

from tpu_mpi_tests_torch.serve.histogram import LatencyHistogram

__all__ = ["LatencyHistogram"]

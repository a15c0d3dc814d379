"""Benchmark drivers (``python -m tpu_mpi_tests_torch.drivers.<name>``)."""

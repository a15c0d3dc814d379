"""tpu_mpi_tests_torch — the PyTorch/CUDA port of ``tpu_mpi_tests``.

The JAX package beside it is the reference; this package re-implements
its main path (the 2-D stencil hot loop of ``mpi_stencil2d_gt.cc:511-535``)
in PyTorch, with every Pallas kernel on that path rewritten by hand in
CUDA C++ for Hopper (``kernels/csrc/``). It imports ``torch`` and never
``jax`` or ``tpu_mpi_tests``.

Layer map (top to bottom, mirroring the JAX package):
  bench.py      headline JSON line (≅ the root ``bench.py``)
  microbench.py the microbench groups (streams, attention)
  drivers/      benchmark drivers (stencil, heat, DAXPY, ``attnbench``)
  instrument/   timers (CUDA events) and the stable report lines
  comm/         world=1 topology, halo exchange, hot-loop runners, ring
                and all-to-all attention
  kernels/      torch-op stencils + hand CUDA kernels with plain twins
  arrays/       ghost-cell domain layouts
  convert.py    JAX-package state → torch tensors

Entry points run on the card (``device="cuda"``) unless the caller asks
for the CPU; asking for the card where there is none raises.
"""

__version__ = "0.1.0"

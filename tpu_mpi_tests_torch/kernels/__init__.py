"""Compute kernels: torch-op stencils (the XLA tier's counterpart) and the
hand-written CUDA kernels (``hand.py``, sources in ``csrc/``), each with
its plain-torch twin beside it."""

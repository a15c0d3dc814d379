"""TPM302: a wall-clock epoch crosses onto a tensor at float32.

``torch.tensor(time.time())`` is float32 (torch's default dtype for a
Python float): its spacing at today's epoch is 128 s, so a raw epoch
that reaches a tensor, or a collective through one, comes back as
quantization noise (the clock-sync hazard the JAX package's TPM302
encodes). A tensor built with an explicit ``dtype=torch.float64``
(``double``) keeps the epoch to a fraction of a microsecond and is not a
finding; neither is a value that passes through a call first (an
encoding helper such as the manifest's integer microseconds is the
sanctioned fix).

TPM301 (a bare float literal whose width depends on JAX's x64 flag) has
no counterpart: torch's float32 default for Python floats is explicit,
documented behaviour, not a silent canonicalisation under a flag.
"""

from __future__ import annotations

import ast
from typing import Iterator

from tpu_mpi_tests_torch.analysis.core import FileContext, last_attr
from tpu_mpi_tests_torch.analysis.rules import _util

#: tensor constructors an epoch must not reach at the default dtype
EPOCH_SINKS = {
    "torch.tensor", "torch.as_tensor", "torch.full",
    "torch.scalar_tensor",
}

#: dtypes wide enough for a wall-clock epoch
WIDE_DTYPES = {"float64", "double"}


class EpochPrecision:
    name = "epoch-precision"
    scope = "file"
    codes = {
        "TPM302": "time.time() epoch value onto a tensor at the default "
                  "float32 (quantized to 128 s)",
    }

    def check(self, ctx: FileContext) -> Iterator[tuple]:
        for call in _util.walk_calls(ctx.tree):
            resolved = ctx.imports.resolve(call.func)
            if resolved not in EPOCH_SINKS:
                continue
            if any(kw.arg == "dtype" and last_attr(kw.value) in WIDE_DTYPES
                   for kw in call.keywords):
                continue
            for arg in list(call.args) + [kw.value for kw in call.keywords]:
                if self._raw_epoch(ctx, arg):
                    yield (
                        call.lineno, call.col_offset, "TPM302",
                        f"time.time() epoch value into "
                        f"{resolved.rsplit('.', 1)[-1]} at torch's "
                        f"default float32 quantizes it to 128 s; pass "
                        f"dtype=torch.float64, encode it as integer "
                        f"microseconds, or keep the timestamp on the host",
                    )
                    break

    def _raw_epoch(self, ctx: FileContext, expr: ast.AST) -> bool:
        """``time.time()`` reaching the sink raw or through arithmetic
        only; a nested call is assumed to encode the value."""
        if isinstance(expr, ast.Call):
            return ctx.imports.resolve(expr.func) == "time.time"
        return any(self._raw_epoch(ctx, child)
                   for child in ast.iter_child_nodes(expr))

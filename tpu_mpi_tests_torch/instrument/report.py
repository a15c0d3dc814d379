"""Structured result reporting: stable stdout lines + JSONL
(≅ ``tpu_mpi_tests/instrument/report.py``, the line shapes kept exactly so
the reference's aggregation workflow parses the port's output):

  ``<rank>/<size> SUM = <v>``
  ``TEST dim:<d>, <space>, buf:<b>; <t>, err=<e>``
  ``ITER dim:<d>, <space>, buf:<b>; <phase> mean=<m>, min=<m>, max=<m>``
"""

from __future__ import annotations

import json
import sys
from typing import IO, Any


class Reporter:
    """Line + JSONL emitter; a context manager that closes the JSONL file.
    Banner lines are rank-0 only, like the reference's."""

    def __init__(self, rank: int = 0, size: int = 1,
                 jsonl_path: str | None = None,
                 stream: IO[str] | None = None):
        self.rank = rank
        self.size = size
        self.jsonl_path = jsonl_path
        self.stream = stream or sys.stdout
        self._jsonl_file: IO[str] | None = None

    def __enter__(self) -> "Reporter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def line(self, text: str, record: dict[str, Any] | None = None):
        print(text, file=self.stream, flush=True)
        if record is not None:
            self.jsonl(record)

    def banner(self, text: str):
        if self.rank == 0:
            self.line(text)

    def sum_line(self, value: float, label: str = "SUM", rank=None):
        r = self.rank if rank is None else rank
        self.line(
            f"{r}/{self.size} {label} = {value:f}",
            {"kind": "sum", "label": label, "rank": r, "size": self.size,
             "value": float(value)},
        )

    def test_line(self, dim: int, space: str, buf, seconds: float,
                  err: float, extra_label: str | None = None,
                  show_err: bool = True):
        space_s = f"{space:7s}"
        if extra_label:
            text = (f"TEST dim:{dim}, {space_s}, buf:{int(buf)}; "
                    f"{extra_label}={seconds:f}")
            if show_err:
                text += f", err={err:e}"
        else:
            text = (f"TEST dim:{dim}, {space_s}, buf:{int(buf)}; "
                    f"{seconds:f}, err={err:e}")
        self.line(
            text,
            {"kind": "test", "dim": dim, "space": space, "buf": int(buf),
             "seconds": float(seconds), "err": float(err),
             "label": extra_label},
        )

    def iter_line(self, dim: int, space: str, buf, phase: str,
                  mean_s: float, min_s: float, max_s: float):
        space_s = f"{space:7s}"
        self.line(
            f"ITER dim:{dim}, {space_s}, buf:{int(buf)}; {phase} "
            f"mean={mean_s:e}, min={min_s:e}, max={max_s:e}",
            {"kind": "iter", "dim": dim, "space": space, "buf": int(buf),
             "phase": phase, "mean_s": float(mean_s),
             "min_s": float(min_s), "max_s": float(max_s)},
        )

    def jsonl(self, record: dict[str, Any]):
        if not self.jsonl_path:
            return
        if self._jsonl_file is None:
            self._jsonl_file = open(self.jsonl_path, "a")
        self._jsonl_file.write(json.dumps(record) + "\n")
        self._jsonl_file.flush()

    def close(self):
        if self._jsonl_file is not None:
            self._jsonl_file.close()
            self._jsonl_file = None

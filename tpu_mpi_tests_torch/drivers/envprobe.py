"""Environment propagation probe (≅ ``tpu_mpi_tests/drivers/envprobe.py``).

≅ ``mpienv.f90``: every rank reads ``MEMORY_PER_CORE`` (or a flag-chosen
variable) and prints what it sees — debugging env propagation through
the launch stack (the reference chased Spectrum-MPI eating this
variable, ``mpi_daxpy.cc:99-101``). One line per process, and with
``--verbose`` one per device; the port runs one process on one device.
"""

from __future__ import annotations

import os
import sys

from tpu_mpi_tests_torch.drivers import _common


def run(args) -> int:
    from tpu_mpi_tests_torch.comm.mesh import bootstrap, topology

    device = bootstrap(args.device)
    topo = topology(device)
    rep = _common.make_reporter(
        args, rank=topo.process_index, size=topo.process_count
    )
    with rep:
        val = os.environ.get(args.var)
        shown = val if val is not None else "<not set>"
        rank = f"{topo.process_index}/{topo.process_count}"
        rep.line(
            f"{rank} {args.var}={shown}",
            {"kind": "envprobe", "var": args.var, "value": val,
             "rank": topo.process_index},
        )
        if args.verbose:
            rep.line(f"{rank} device {device.index or 0} "
                     f"({topo.device_kinds[0]}) sees {args.var}={shown}")
        return 0


def main(argv=None) -> int:
    p = _common.base_parser(__doc__)
    p.add_argument(
        "--var",
        default="MEMORY_PER_CORE",
        help="environment variable to probe (reference: MEMORY_PER_CORE)",
    )
    args = p.parse_args(argv)
    return _common.run_guarded(run, args)


if __name__ == "__main__":
    sys.exit(main())

"""In-place allgather semantics probe, one process per rank (≅
``tpu_mpi_tests/drivers/gather_inplace.py``).

≅ ``mpigatherinplace.f90``: every rank fills its own slice of a shared
global array, does ``MPI_Allgather(MPI_IN_PLACE)``, and prints its local
sum next to the global sum; the global sum must equal the sum of local
sums exactly. Reference size: 128Mi doubles per rank (``:11``); the
default here is smaller and flag-scalable.

Rank r's slice is filled with ``r + 1`` (``mpigatherinplace.f90:33-36``),
so local sums are ``(r+1)*n`` and the global sum is ``n *
world*(world+1)/2`` — integer-exact in every dtype up to large n. The
library tier gathers the full-size buffer in place over the process group
(``C.all_gather_inplace``); ``--rdma`` gathers each rank's slice through
the hand ring all-gather kernel (``C.all_gather_rdma``), as the JAX
driver does.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from tpu_mpi_tests_torch.drivers import _common


def run(args) -> int:
    from tpu_mpi_tests_torch.comm import collectives as C
    from tpu_mpi_tests_torch.comm.mesh import bootstrap, topology
    from tpu_mpi_tests_torch.instrument.timers import block

    dtype = _common.torch_dtype(args)
    device = bootstrap(args.device)
    topo = topology(device)
    world = topo.global_device_count
    rank = topo.process_index
    n = args.n_per_rank

    rep = _common.make_reporter(args, rank=rank, size=world)
    with rep:
        local_sums = [(r + 1) * n for r in range(world)]
        if args.rdma:
            # hand-written RDMA ring tier (≅ hand-coding the
            # MPI_Allgather): each rank's own slice in, the gathered
            # global buffer out
            mine = torch.full((n,), float(rank + 1), dtype=dtype,
                              device=device)
            g = block(C.all_gather_rdma(mine))
        else:
            # fill own slice of the full-size buffer, gather in place
            allx = torch.zeros(world * n, dtype=dtype, device=device)
            allx[rank * n:(rank + 1) * n] = rank + 1
            g = block(C.all_gather_inplace(allx))
        asum = float(C.host_value(g).astype(np.float64, copy=False).sum())

        for r in range(world):
            rep.line(
                f"{r}/{world} lsum={local_sums[r]:.1f} asum={asum:.1f}",
                {"kind": "gather_inplace", "rank": r, "lsum": local_sums[r],
                 "asum": asum},
            )

        expected = float(sum(local_sums))
        if asum != expected:
            rep.line(f"PARITY FAIL: asum {asum} != sum of lsums {expected}")
            return 1
        return 0


def main(argv=None) -> int:
    p = _common.base_parser(__doc__)
    p.add_argument(
        "--n-per-rank",
        type=int,
        default=1 << 20,
        help="elements per rank (reference: 128Mi doubles)",
    )
    p.add_argument(
        "--rdma",
        action="store_true",
        help="gather through the hand-written RDMA ring "
        "(collectives.all_gather_rdma) instead of the library all-gather",
    )
    args = p.parse_args(argv)
    if args.n_per_rank < 1:
        p.error(f"--n-per-rank must be positive, got {args.n_per_rank}")
    return run(args)


if __name__ == "__main__":
    sys.exit(main())

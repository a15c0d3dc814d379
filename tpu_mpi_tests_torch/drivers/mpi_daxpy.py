"""Multi-rank DAXPY with device + managed allocation pairs (≅
``tpu_mpi_tests/drivers/mpi_daxpy.py``).

≅ ``mpi_daxpy.cc`` / ``mpi_daxpy_gt.cc``: every rank runs the same DAXPY
on its block; both an explicit-device pair and a "managed" pair are
allocated and introspected (``MEMINFO`` with ``--verbose``), the kernel
runs on the **managed** pair (``mpi_daxpy.cc:140-141``) and each rank
prints ``rank/size SUM = <v>``. The ``MEMORY_PER_CORE`` env probe
(``:99-108``) is preserved.

The port runs one process per rank, each on its own card (torchrun,
tpumt_run; one process without a launcher): each holds its block of the
global arrays, and the per-rank sums are gathered over the process
group. ``--ranks k·w`` puts k logical ranks on each of the w (the
reference's ``ranks_per_device`` oversubscription,
``mpi_daxpy.cc:49-51``), each summing its own block. MANAGED is emulated
(a pinned host tensor moved to the card on first use,
``arrays/spaces.py``).
"""

from __future__ import annotations

import os
import sys

import numpy as np

from tpu_mpi_tests_torch.drivers import _common


def run(args) -> int:
    import tpu_mpi_tests_torch.kernels.daxpy as kd
    from tpu_mpi_tests_torch.arrays.spaces import (
        Space,
        ensure_device,
        meminfo,
        place,
    )
    from tpu_mpi_tests_torch.comm import collectives as C
    from tpu_mpi_tests_torch.comm.mesh import (
        bootstrap,
        device_report,
        ranks_per_device,
        topology,
    )
    from tpu_mpi_tests_torch.instrument.timers import block
    from tpu_mpi_tests_torch.utils import TpuMtError, check_divisible

    dtype = _common.torch_dtype(args)
    device = bootstrap(args.device)
    topo = topology(device)
    n_dev = topo.global_device_count
    world = args.ranks or n_dev
    if world < n_dev:
        raise TpuMtError(
            f"--ranks {world} < device count {n_dev}: undersubscription is "
            "not emulated (shards must cover every device)"
        )
    k = ranks_per_device(world)
    n = check_divisible(args.n_total, world, "n_total over ranks")

    rep = _common.make_reporter(args, rank=topo.process_index, size=world)
    with rep:
        if k > 1:
            rep.banner(f"{world} logical ranks over {n_dev} devices "
                       f"({k} ranks/device)")

        # env probe (mpi_daxpy.cc:99-108)
        mb_per_core = os.environ.get("MEMORY_PER_CORE")
        if mb_per_core is None:
            rep.banner("MEMORY_PER_CORE is not set")
        else:
            rep.banner(f"MEMORY_PER_CORE={mb_per_core}")
        rep.banner(device_report(device, verbose=args.verbose))

        # every rank initializes the same local values x=i+1, y=-(i+1)
        # (mpi_daxpy.cc:94-97) — globally that's the per-rank pattern tiled
        lx, ly = kd.init_xy_np(n, _common.numpy_dtype(args))
        h_x = _common.host_tensor(np.tile(lx, world), dtype)
        h_y = _common.host_tensor(np.tile(ly, world), dtype)

        # explicit-device pair AND managed pair (mpi_daxpy.cc:115-119),
        # each this rank's block
        d_x = C.shard_1d(h_x, device)
        d_y = C.shard_1d(h_y, device)
        m_x = place(C.shard_1d(h_x, "cpu"), Space.MANAGED, device)
        m_y = place(C.shard_1d(h_y, "cpu"), Space.MANAGED, device)
        if args.verbose:
            for name, a in [("d_x", d_x), ("d_y", d_y), ("m_x", m_x),
                            ("m_y", m_y)]:
                rep.line(f"MEMINFO {name}: {meminfo(a)}")

        # kernel runs on the managed pair (mpi_daxpy.cc:140-141); managed
        # tensors move to the card on first device use (arrays/spaces.py)
        m_x, m_y = ensure_device(m_x, device), ensure_device(m_y, device)
        m_y = block(kd.daxpy(args.a, m_x, m_y))

        # per-rank checksums of the managed result (mpi_daxpy.cc:152-156)
        sums = C.per_rank_sums(m_y, groups_per_shard=k).astype(np.float64)
        for r in range(world):
            rep.sum_line(sums[r], rank=r)

        expected = kd.expected_checksum(n)
        tol = 0 if args.dtype == "float64" else max(1e-5 * expected, 1.0)
        ok = all(abs(s - expected) <= tol for s in sums)
        if not ok:
            rep.line(f"CHECKSUM FAIL: {sums} != {expected}")
            return 1
        del d_x, d_y
        return 0


def main(argv=None) -> int:
    p = _common.base_parser(__doc__)
    p.add_argument(
        "--n-total",
        type=int,
        default=1 << 20,
        help="total elements across ranks (split evenly)",
    )
    p.add_argument("--a", type=float, default=2.0)
    p.add_argument(
        "--ranks",
        type=int,
        default=None,
        help="logical rank count; more ranks than devices emulates "
        "oversubscription (≅ more MPI ranks than GPUs, mpi_daxpy.cc:49-51)",
    )
    args = p.parse_args(argv)
    if args.n_total < 1:
        p.error(f"--n-total must be positive, got {args.n_total}")
    if args.ranks is not None and args.ranks < 1:
        p.error(f"--ranks must be positive, got {args.ranks}")
    return _common.run_guarded(run, args)


if __name__ == "__main__":
    sys.exit(main())

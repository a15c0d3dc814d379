"""Flagship 2-D stencil benchmark (≅ ``tpu_mpi_tests/drivers/stencil2d.py``,
itself ≅ ``mpi_stencil2d_gt.cc``), one process per rank.

A 2-D array is decomposed along the derivative dim (0 or 1) over the
ranks; each test runs ``n_warmup`` untimed + ``n_iter`` timed halo
exchanges, applies the 5-point stencil, and reports the exchange time plus
the error norm vs the analytic derivative of z = x³ + y²::

    TEST dim:<d>, device , buf:<b>; <seconds>, err=<e>

followed by the axis-reduction + allreduce benchmark (``test_sum``,
``mpi_stencil2d_gt.cc:574-649``)::

    TEST dim:<d>, device , buf:0; allreduce=<seconds>

Staging per the reference's ``buf`` flag: dim 0 → ``buf:0`` device
staged, ``buf:1`` host staged; dim 1 → ``buf:0`` direct, ``buf:1``
device staged; ``--rdma`` runs every leg through the hand RDMA ring
(``hand.ring_halo``, ≅ the SYCL hand-kernel variant of the matrix) and
the allreduce through the hand ring reduce-scatter + all-gather
(``C.allreduce_rdma``, as the JAX driver does). At
world=1 the non-periodic exchange moves nothing, as in the JAX package's
single-device runs (the RDMA ring still launches).

``--kernel hand`` runs the derivative through the hand CUDA kernel (≅
``--kernel pallas``) and hands the device-staged legs the hand
pack/unpack kernels. ``--iterate-tier {blocks,rdma-chained,rdma-fused,
xla,auto}`` adds the iterate leg (exchange + k-step update hot loop) with
its analytic eigen gate, the fused == chained bitwise gate (``ITER
BITWISE``) and the fused tier's OVERLAP record. The card is the default
device; ``--device cpu`` runs the kernels' plain torch versions (over gloo
at world > 1). Not ported yet: ``--managed``, ``--tune``, ``--kernel
auto``, ``--fused``, ``--debug-dump``.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from tpu_mpi_tests_torch.arrays.domain import Domain2D
from tpu_mpi_tests_torch.comm import collectives as C
from tpu_mpi_tests_torch.comm import halo as H
from tpu_mpi_tests_torch.comm.mesh import bootstrap, topology
from tpu_mpi_tests_torch.drivers import _common
from tpu_mpi_tests_torch.instrument.timers import PhaseTimer, block
from tpu_mpi_tests_torch.kernels import hand
from tpu_mpi_tests_torch.kernels.reductions import sum_axis
from tpu_mpi_tests_torch.kernels.stencil import (
    N_BND,
    STENCIL5,
    analytic_pairs,
)


def _deriv_test(args, topo, rep, dim: int, buf: bool) -> int:
    device = topo.device
    dtype = _common.torch_dtype(args)
    world = topo.global_device_count
    d = Domain2D(n_local_deriv=args.n_local, n_global_other=args.n_other,
                 n_shards=world, dim=dim)
    f, df = analytic_pairs()[f"2d_dim{dim}"]
    if args.rdma:
        # the hand RDMA ring replaces every staged path
        staging = H.Staging.PALLAS_RDMA
    elif dim == 0:
        staging = H.Staging.HOST_STAGED if buf else H.Staging.DEVICE_STAGED
    else:
        staging = H.Staging.DEVICE_STAGED if buf else H.Staging.DIRECT

    if args.init == "device":
        zg = C.device_init(lambda r: d.init_shard_torch(f, r, dtype, device))
    else:
        zg = C.shard_blocks(d.global_ghosted_shape, dtype,
                            lambda r: d.init_shard(f, r, np.float64),
                            device, axis=dim)

    # hot loop ≅ mpi_stencil2d_gt.cc:511-535: clock around the exchange,
    # the stencil every iteration (untimed but executing), a device sync
    # closing each iteration; warmup entries are not accumulated
    stencil = H.stencil_fn(dim, d.scale, kernel=args.kernel)
    timer = PhaseTimer(skip_first=args.n_warmup)
    zg = block(H.staging_buffer(zg, staging))
    dz = None
    for _ in range(args.n_warmup + args.n_iter):
        zg = timer.timed("exchange", H.halo_exchange, zg, dim, d.n_bnd,
                         False, staging, kernel=args.kernel)
        dz = block(stencil(zg))
    seconds = timer.seconds["exchange"]

    if args.init == "device":
        actual = C.device_init(
            lambda r: d.interior_shard_torch(df, r, dtype, device))
    else:
        actual = C.shard_blocks(d.global_interior_shape, dtype,
                                lambda r: d.interior_shard(df, r),
                                device, axis=dim)
    per_rank = C.per_rank_err_norms(dz, actual)
    del zg, dz, actual
    err_sum = float(per_rank.sum())
    rep.test_line(dim, "device", buf, seconds * world, err_sum)
    rep.iter_line(dim, "device", buf, "exchange", timer.mean("exchange"),
                  timer.mins.get("exchange", 0.0),
                  timer.maxs.get("exchange", 0.0))

    tol = args.tol if args.tol is not None else _default_tol(args, d)
    if per_rank.max() > tol:
        rep.line(f"ERR_NORM FAIL dim:{dim} device buf:{int(buf)}: "
                 f"max {per_rank.max():.8g} > tol {tol:.8g}")
        return 1
    return 0


def _default_tol(args, d) -> float:
    """The JAX driver's dtype-dependent err-norm gate, unchanged."""
    if args.dtype == "float64":
        return 1e-5
    eps = 7.8e-3 if args.dtype == "bfloat16" else 1.2e-7
    other_extent = d.length * d.n_global_other / d.n_global_deriv
    x_max = d.length if d.dim == 0 else other_extent
    y_max = other_extent if d.dim == 0 else d.length
    zmax = x_max**3 + y_max**2
    n_pts = d.n_global_deriv * d.n_global_other
    return 8 * eps * zmax * d.scale * np.sqrt(n_pts / d.n_shards)


def _sum_test(args, topo, rep, dim: int) -> int:
    """Axis reduction + timed allreduce (≅ test_sum, :574-649): local sum
    along the decomposed dim, then the allreduce (under ``--rdma`` the
    hand ring, ``C.allreduce_rdma``); its cost is the difference of loops
    with and without it."""
    dtype = _common.torch_dtype(args)
    world = topo.global_device_count
    d = Domain2D(n_local_deriv=args.n_local, n_global_other=args.n_other,
                 n_shards=world, dim=dim)
    z = torch.full(d.local_shape, np.pi / world, dtype=dtype,
                   device=topo.device)

    def local_sum(zz):
        return sum_axis(zz, axis=dim).reshape(1, -1)

    allreduce = C.allreduce_sum
    if args.rdma:
        # hand tier: the ring reduce-scatter + all-gather kernels instead
        # of the library allreduce (≅ hand-writing the in-place
        # MPI_Allreduce the reference times, mpi_stencil2d_gt.cc:615-625);
        # where the ring's chunking refuses the row, the library tier runs
        # with a visible NOTE, never silently
        why = C.allreduce_rdma_refusal(d.n_global_other)
        if why is None:
            allreduce = C.allreduce_rdma
        else:
            rep.line(f"NOTE dim:{dim} device: rdma allreduce below "
                     f"alignment floor, using allreduce_sum ({why})")

    expected = np.full(d.n_global_other, np.pi * args.n_local)
    s = block(allreduce(local_sum(z)))
    got = C.host_value(s).reshape(-1)
    if not np.allclose(got, expected,
                       rtol=1e-3 if args.dtype == "bfloat16" else 1e-5):
        rep.line(f"ALLREDUCE FAIL dim:{dim} device: {got[:3]} != "
                 f"{expected[:3]}")
        return 1

    t0 = time.perf_counter()
    for _ in range(args.n_iter):
        s = allreduce(local_sum(z))
    block(s)
    t_with = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(args.n_iter):
        s = local_sum(z)
    block(s)
    t_without = time.perf_counter() - t0

    seconds = max(t_with - t_without, 0.0)
    if t_with < t_without:
        rep.line(
            f"NOTE dim:{dim} device: allreduce difference clamped to 0 "
            f"(t_with={t_with:.6f} < t_without={t_without:.6f}; "
            "loop noise exceeds the allreduce cost at this size)"
        )
    rep.test_line(dim, "device", 0, seconds * world, 0.0,
                  extra_label="allreduce", show_err=False)
    rep.jsonl({"kind": "allreduce_raw", "dim": dim, "space": "device",
               "n_iter": args.n_iter, "t_with_s": t_with,
               "t_without_s": t_without, "world": world})
    return 0


def _iterate_tiers(args, topo):
    """Tier-runner builders for the iterate leg on ONE dim-0 periodic
    geometry: each rank's interior rows hold its part of the eigenfield
    sin(2π·m·i/n), ghosts start zero (the first exchange fills them).
    Returns ``(build, make_state, timesteps_per_call, geom)``; ``build``
    may raise ``ValueError`` for a tier the geometry does not fit."""
    dtype = _common.torch_dtype(args)
    device = topo.device
    world, rank = topo.global_device_count, topo.process_index
    steps = args.iterate_steps
    K = N_BND * steps
    nloc, cols = args.n_local, args.n_other
    n_glob = world * nloc
    se = 0.01  # scale_eps of the iterate update
    m = 2
    phase = 2.0 * np.pi * m / n_glob

    def ghost_width(tier):
        # the torch-op tier exchanges every timestep over radius-wide
        # ghosts; the k-step hand tiers carry deep halos
        return N_BND if tier == "xla" else K

    def make_state(gw=K):
        z = torch.zeros((nloc + 2 * gw, cols), dtype=dtype, device=device)
        rows = torch.arange(rank * nloc, (rank + 1) * nloc,
                            dtype=torch.float64, device=device)
        z[gw:gw + nloc] = torch.sin(phase * rows).to(dtype)[:, None]
        return z

    n_blocks = H.PRIOR_BLOCKS.get(args.dtype, H.PRIOR_BLOCKS["float32"])

    def build(tier):
        if tier == "xla":
            return H.iterate_fused_fn(0, N_BND, 1.0, se, periodic=True)
        if tier == "rdma-chained":
            return H.iterate_hand_fn(K, se, axis=0, steps=steps,
                                     periodic=True, rdma=True)
        if tier == "rdma-fused":
            hand.fused_block_rows(nloc + 2 * K, steps)  # raises if no fit
            return H.iterate_fused_rdma_fn(K, se, steps=steps,
                                           periodic=True)
        if n_blocks >= 2 and nloc % n_blocks == 0:
            inner = H.iterate_hand_blocks_fn(n_blocks, K, se, steps=steps,
                                             periodic=True)

            def run_blocks(z, n):
                st = H.split_blocks(z, n_blocks, K)
                return H.merge_blocks(inner(st, n), K)

            return run_blocks
        return H.iterate_hand_fn(K, se, axis=0, steps=steps, periodic=True)

    geom = {"steps": steps, "K": K, "n_glob": n_glob, "cols": cols,
            "se": se, "phase": phase, "ghost_width": ghost_width}
    return build, make_state, (lambda t: 1 if t == "xla" else steps), geom


def _all_ranks_agree(ok: bool) -> bool:
    """``ok`` on every rank (a count of the ranks where it fails)."""
    return C.reduce_sum([0.0 if ok else 1.0]) == 0.0


def _iterate_tier_test(args, topo, rep) -> int:
    """The kernel-tier iterate leg: time the exchange + update hot loop
    under the chosen tier (``auto`` = the prior, ``blocks``), then run the
    honesty checks of the JAX driver (``drivers/stencil2d.py:471``):

    * fused == chained, bitwise (``ITER BITWISE``): the two RDMA tiers
      share the tile update and the ghost bytes, so a seam or exchange bug
      breaks the equality at once;
    * the analytic eigen gate on the timed field: on the periodic ring the
      eigenfield sin(m·x) rotates through (sin, cos) by an exactly known
      2×2 map per timestep;
    * the fused tier's OVERLAP record: the fused runner against its
      compute-only twin, host-bracketed (:func:`H.fused_overlap_record`).
    """
    world = topo.global_device_count
    build, make_state, steps_per_call, g = _iterate_tiers(args, topo)
    steps, K, n_glob = g["steps"], g["K"], g["n_glob"]
    tier = H.PRIOR_TIER if args.iterate_tier == "auto" else args.iterate_tier
    H.check_tier(tier)

    gw = g["ghost_width"](tier)
    run = build(tier)
    z = block(run(make_state(gw), 1))  # build kernels + warm
    C.barrier(topo.device)
    t0 = time.perf_counter()
    z = block(run(z, args.iterate_iters))
    seconds = time.perf_counter() - t0
    # the warm call advanced the field too: the eigen gate checks the
    # TOTAL evolution, the rate only the timed window
    timesteps = (1 + args.iterate_iters) * steps_per_call(tier)
    rate = (args.iterate_iters * steps_per_call(tier) / seconds
            if seconds > 0 else float("inf"))
    rep.line(f"ITER tier={tier} steps={steps} n={n_glob}x{g['cols']} "
             f"world={world}: {rate:0.1f} steps/s")

    rc = 0
    try:
        fused, chained = build("rdma-fused"), build("rdma-chained")
        za = C.host_value(block(fused(make_state(), args.iterate_iters)))
        zb = C.host_value(block(chained(make_state(), args.iterate_iters)))
        if _all_ranks_agree(bool(np.array_equal(za, zb))):
            rep.line(f"ITER BITWISE fused==chained over "
                     f"{args.iterate_iters} calls: OK")
        else:
            d = np.abs(za.astype(np.float64) - zb.astype(np.float64))
            rep.line(f"ITER BITWISE FAIL: fused and chained tiers diverge "
                     f"(max |d|={np.nanmax(d):.8g} on rank "
                     f"{topo.process_index})")
            rc = 1
    except ValueError as e:
        rep.line(f"NOTE fused/chained bitwise gate skipped ({e})")

    c1, c2 = float(STENCIL5[3]), float(STENCIL5[4])
    a = g["se"] * (2.0 * c1 * np.sin(g["phase"])
                   + 2.0 * c2 * np.sin(2.0 * g["phase"]))
    sc = np.array([1.0, 0.0])
    step_m = np.array([[1.0, -a], [a, 1.0]])
    for _ in range(timesteps):
        sc = step_m @ sc
    rows = np.arange(n_glob)
    want = sc[0] * np.sin(g["phase"] * rows) + sc[1] * np.cos(
        g["phase"] * rows)
    col = z[gw:gw + args.n_local, 0].contiguous()
    got = C.host_value(C.all_gather(col)).astype(np.float64)
    denom = max(float(np.sqrt(np.mean(want**2))), 1e-300)
    rel = float(np.sqrt(np.mean((got - want) ** 2))) / denom
    eps = {"float64": 2.3e-16, "float32": 1.2e-7,
           "bfloat16": 7.8e-3}.get(args.dtype, 1.2e-7)
    tol = min(0.5, 50.0 * eps * max(timesteps, 1) ** 0.5 + 10.0 * eps)
    rep.line(f"ITER ERR rel={rel:e} (gate {tol:e})")
    if not np.isfinite(rel) or rel > tol:
        rep.line(f"ITER FAIL rel={rel:.8g} > tol {tol:.8g}")
        rc = 1

    # kernel-level overlap record: the fused runner against its
    # compute-only twin (same kernel, the exchange compiled out)
    try:
        fused = build("rdma-fused")
        comp = H.iterate_fused_rdma_fn(K, g["se"], steps=steps,
                                       periodic=True, local_only=True)
        zf = block(fused(make_state(), 1))  # warm
        zc = block(comp(make_state(), 1))
        C.barrier(topo.device)
        t0 = time.perf_counter()
        zf = block(fused(zf, args.iterate_iters))
        fused_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        zc = block(comp(zc, args.iterate_iters))
        compute_s = time.perf_counter() - t0
        del zf, zc
        ov = H.fused_overlap_record(
            "stencil2d_fused_rdma", steps=args.iterate_iters,
            fused_s=fused_s, compute_s=compute_s, world=world,
            dtype=args.dtype,
        )
        rep.line(
            f"OVERLAP stencil2d_fused_rdma "
            f"overlap_frac={ov['overlap_frac']:0.3f} "
            f"seam_wait_s={ov['drain_s']:0.6f}",
            ov,
        )
    except ValueError as e:
        rep.line(f"NOTE fused overlap probe skipped ({e})")
    return rc


def run(args) -> int:
    device = bootstrap(args.device)
    topo = topology(device)
    world = topo.global_device_count
    with _common.make_reporter(args) as rep:
        rep.banner(
            f"stencil2d: n_local={args.n_local} n_other={args.n_other} "
            f"world={world} n_iter={args.n_iter} n_warmup={args.n_warmup} "
            f"dtype={args.dtype} managed=False device={topo.device_kinds[0]}"
            f" kernel={args.kernel} rdma={args.rdma}"
        )
        rc = 0
        if args.iterate_tier != "off":
            rc |= _iterate_tier_test(args, topo, rep)
            if args.iterate_only:
                return rc
        only = None
        if args.only:
            only = {
                (int(d), int(b))
                for d, b in (pair.split(":") for pair in args.only.split(","))
            }
        for dim in (0, 1):
            for buf in (True, False):
                if only is not None and (dim, int(buf)) not in only:
                    continue
                rc |= _deriv_test(args, topo, rep, dim, buf)
        for dim in (0, 1):
            if only is not None and not any(d == dim for d, _ in only):
                continue
            rc |= _sum_test(args, topo, rep, dim)
        return rc


def main(argv=None) -> int:
    p = _common.base_parser(__doc__)
    p.add_argument("--n-local", type=int, default=1024,
                   help="per-shard size along the derivative dim "
                   "(≅ n_local_deriv, default 1024, mpi_stencil2d_gt.cc:656)")
    p.add_argument("--n-other", type=int, default=512 * 1024,
                   help="global size of the non-decomposed dim "
                   "(≅ n_global_other = 512Ki, mpi_stencil2d_gt.cc:676)")
    p.add_argument("--n-iter", type=int, default=1000,
                   help="timed iterations (≅ :657)")
    p.add_argument("--n-warmup", type=int, default=5,
                   help="untimed warmup (≅ :658)")
    p.add_argument("--kernel", default="torch", choices=["torch", "hand"],
                   help="derivative implementation: torch ops (≅ gtensor / "
                   "the XLA tier) or the hand CUDA kernel (≅ the SYCL "
                   "kernel / --kernel pallas)")
    p.add_argument("--rdma", action="store_true",
                   help="use the hand RDMA ring (hand.ring_halo) for every "
                   "exchange (≅ the SYCL hand-kernel variant of the "
                   "matrix)")
    p.add_argument("--iterate-tier", default="off",
                   choices=["off", "auto", *H.STENCIL_TIERS],
                   help="run the iterate leg under the named tier (auto = "
                   "the prior, blocks), with the fused-vs-chained bitwise "
                   "gate, the analytic eigen gate and the fused tier's "
                   "OVERLAP record")
    p.add_argument("--iterate-steps", type=int, default=1,
                   help="temporal-blocking depth of the iterate leg")
    p.add_argument("--iterate-iters", type=int, default=4,
                   help="timed outer iterations of the iterate leg")
    p.add_argument("--iterate-only", action="store_true",
                   help="run ONLY the iterate leg")
    p.add_argument("--init", default="device", choices=["device", "host"],
                   help="compute initial fields on the device (f64, cast "
                   "once) or on the host with numpy (≅ the reference's "
                   "host init + H2D copy)")
    p.add_argument("--only", default=None,
                   help="run a subset of the matrix as 'dim:buf' pairs, "
                   "e.g. '0:0,1:0'")
    p.add_argument("--tol", type=float, default=None,
                   help="per-rank err_norm gate (default dtype-dependent)")
    args = p.parse_args(argv)
    for name in ("n_local", "n_other", "n_iter", "iterate_steps",
                 "iterate_iters"):
        if getattr(args, name) < 1:
            p.error(f"--{name.replace('_', '-')} must be positive")
    if args.n_local < 5:
        p.error("--n-local must be >= 5 (stencil width)")
    if args.iterate_only and args.iterate_tier == "off":
        p.error("--iterate-only needs an --iterate-tier selection")
    return run(args)


if __name__ == "__main__":
    sys.exit(main())

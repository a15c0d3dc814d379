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
pack/unpack kernels; ``--kernel auto`` maps the ``stencil/tier``
resolution onto the two bodies (resolved after the iterate leg, so a
same-run sweep's winner applies). ``--iterate-tier {blocks,rdma-chained,
rdma-fused,xla,auto}`` adds the iterate leg (exchange + k-step update hot
loop) with its analytic eigen gate, the fused == chained bitwise gate
(``ITER BITWISE``) and the fused tier's OVERLAP record; ``auto`` resolves
``stencil/tier`` explicit > cached > prior, and under ``--tune`` a cache
miss sweeps the tiers first (rank 0 decides, every rank applies). The
blocks tier's block count is resolved once and broadcast from rank 0.

``--managed`` adds the managed-space twins of the matrix and of the
allreduce test (the field starts in pinned host memory and moves to the
device on its first use, ``arrays/spaces.py``), each with its
``nbytes_report`` line. ``--fused`` times exchange + torch-op stencil as
one callable (``halo.exchange_stencil_fused_fn``; the ITER phase is
``fused``, and the host-staged leg prints the JAX ``SKIP`` line).
``--debug-dump`` prints each rank's ghost and edge rows after the
exchange (the ``DEBUG rank r lo/hi ghost+edge`` lines).

The card is the default device; ``--device cpu`` runs the kernels' plain
torch versions (over gloo at world > 1).
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from tpu_mpi_tests_torch.arrays import spaces as SP
from tpu_mpi_tests_torch.arrays.domain import Domain2D
from tpu_mpi_tests_torch.comm import collectives as C
from tpu_mpi_tests_torch.comm import halo as H
from tpu_mpi_tests_torch.comm.mesh import bootstrap, topology
from tpu_mpi_tests_torch.drivers import _common
from tpu_mpi_tests_torch.instrument import costs, telemetry
from tpu_mpi_tests_torch.instrument.timers import PhaseTimer, block, \
    chain_rate
from tpu_mpi_tests_torch.kernels import hand
from tpu_mpi_tests_torch.kernels.reductions import sum_axis
from tpu_mpi_tests_torch.kernels.stencil import (
    N_BND,
    STENCIL5,
    analytic_pairs,
)
from tpu_mpi_tests_torch.tune import fleet
from tpu_mpi_tests_torch.tune import priors as _priors
from tpu_mpi_tests_torch.tune import registry as _tune
from tpu_mpi_tests_torch.tune.sweep import ensure_tuned


def _deriv_test(args, topo, rep, dim: int, buf: bool,
                space: str = "device") -> int:
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

    fused = None
    if args.fused:
        if staging not in (H.Staging.DIRECT, H.Staging.DEVICE_STAGED):
            rep.line(
                f"SKIP dim:{dim}, {space}, buf:{int(buf)}: --fused supports "
                "only DIRECT/DEVICE_STAGED exchanges"
            )
            return 0
        fused = H.exchange_stencil_fused_fn(
            dim, d.n_bnd, d.scale,
            staged=staging is H.Staging.DEVICE_STAGED)

    if args.init == "device":
        zg = C.device_init(lambda r: d.init_shard_torch(f, r, dtype, device))
    else:
        zg = C.shard_blocks(d.global_ghosted_shape, dtype,
                            lambda r: d.init_shard(f, r, np.float64),
                            device, axis=dim)
    if space == "managed":
        # the managed twin starts host-resident and moves to the device
        # on its first use (the first, untimed, exchange)
        zg = SP.place(zg, space, device)
        rep.line(f"MEMINFO dim:{dim}, {space}, buf:{int(buf)}: "
                 f"{SP.nbytes_report(zg)}")

    # hot loop ≅ mpi_stencil2d_gt.cc:511-535: clock around the exchange,
    # the stencil every iteration (untimed but executing), a device sync
    # closing each iteration; warmup entries are not accumulated.
    # --fused times exchange + stencil as one callable instead
    stencil = H.stencil_fn(dim, d.scale, kernel=args.kernel)
    timer = PhaseTimer(skip_first=args.n_warmup)
    phase_name = "fused" if fused is not None else "exchange"

    def exchange(z):
        return H.halo_exchange(SP.ensure_device(z, device), dim, d.n_bnd,
                               False, staging, kernel=args.kernel)

    zg = block(H.staging_buffer(zg, staging))
    dz = None
    for _ in range(args.n_warmup + args.n_iter):
        if fused is not None:
            zg = SP.ensure_device(zg, device)
            dz = timer.timed(phase_name, fused, zg)
        else:
            zg = timer.timed(phase_name, exchange, zg)
            dz = block(stencil(zg))
    seconds = timer.seconds[phase_name]
    if args.debug_dump:
        if fused is not None:
            # the fused callable's exchange is its own; run one standalone
            # exchange before the dump, as the JAX driver does
            zg = block(exchange(zg))
        _debug_dump(rep, zg, dim, d.n_bnd, topo.process_index)

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
    rep.test_line(dim, space, buf, seconds * world, err_sum,
                  extra_label="fused" if fused is not None else None)
    rep.iter_line(dim, space, buf, phase_name, timer.mean(phase_name),
                  timer.mins.get(phase_name, 0.0),
                  timer.maxs.get(phase_name, 0.0))

    tol = args.tol if args.tol is not None else _default_tol(args, d)
    if per_rank.max() > tol:
        rep.line(f"ERR_NORM FAIL dim:{dim} {space} buf:{int(buf)}: "
                 f"max {per_rank.max():.8g} > tol {tol:.8g}")
        return 1
    return 0


def _debug_dump(rep, zg, dim: int, n_bnd: int, rank: int) -> None:
    """This rank's ghost rows and the interior edge rows beside them, lo
    then hi (≅ the JAX driver's dump, itself ≅ the DEBUG halo dumps of
    ``mpi_stencil2d_sycl_oo.cc:636-659``), in the JAX driver's text: a
    dim-0 block shows its first 4 columns, a dim-1 block its first 4 rows
    transposed."""
    sl = [slice(0, 4), slice(0, 4)]  # only the 4 printed lines move
    for label, lohi in (("lo", slice(0, 2 * n_bnd)),
                        ("hi", slice(zg.shape[dim] - 2 * n_bnd, None))):
        sl[dim] = lohi
        edge = C.host_value(zg[tuple(sl)])
        flat = np.array2string(
            edge if dim == 0 else edge.T, precision=4, max_line_width=120,
        )
        rep.line(f"DEBUG rank {rank} {label} ghost+edge:\n{flat}")


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


def _sum_test(args, topo, rep, dim: int, space: str = "device") -> int:
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
    if space == "managed":
        # host-resident until its first device use, right below
        z = SP.place(z, space, topo.device)
        rep.line(f"MEMINFO dim:{dim}, {space}: {SP.nbytes_report(z)}")
        z = SP.ensure_device(z, topo.device)

    def local_sum(zz):
        return sum_axis(zz, axis=dim).reshape(1, -1)

    # the library tier is the process group's all_reduce itself, as the
    # JAX driver's is a bare psum: no telemetry span (the hand tier below
    # goes through its recorded wrapper, as the JAX driver's does)
    allreduce = C.allreduce_unrecorded
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
            rep.line(f"NOTE dim:{dim} {space}: rdma allreduce below "
                     f"alignment floor, using allreduce_sum ({why})")

    expected = np.full(d.n_global_other, np.pi * args.n_local)
    s = block(allreduce(local_sum(z)))
    got = C.host_value(s).reshape(-1)
    if not np.allclose(got, expected,
                       rtol=1e-3 if args.dtype == "bfloat16" else 1e-5):
        rep.line(f"ALLREDUCE FAIL dim:{dim} {space}: {got[:3]} != "
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
            f"NOTE dim:{dim} {space}: allreduce difference clamped to 0 "
            f"(t_with={t_with:.6f} < t_without={t_without:.6f}; "
            "loop noise exceeds the allreduce cost at this size)"
        )
    rep.test_line(dim, space, 0, seconds * world, 0.0,
                  extra_label="allreduce", show_err=False)
    rep.jsonl({"kind": "allreduce_raw", "dim": dim, "space": space,
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

    # the blocks tier's block count, resolved ONCE and broadcast from
    # rank 0: per-rank caches can differ (rank 0 is the one writer), and
    # ranks building different block counts inside a swept candidate
    # would run different exchanges (≅ JAX stencil2d.py:408-431)
    n_blocks = H.resolve_stencil_blocks(dtype=args.dtype, n=n_glob,
                                        world=world)
    if fleet.process_count() > 1:
        try:
            n_blocks = int(fleet.bcast(
                n_blocks if fleet.process_index() == 0 else None,
                "stencil2d/iterate_blocks",
            ))
        except fleet.FleetUnavailable:
            pass  # no transport: the local resolution

    def build(tier):
        if tier.startswith("rdma"):
            why = H.rdma_refusal()
            if why is not None:
                raise ValueError(f"tier {tier} cannot run here ({why})")
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
            "se": se, "phase": phase, "ghost_width": ghost_width,
            "n_blocks": n_blocks}
    return build, make_state, (lambda t: 1 if t == "xla" else steps), geom


def resolve_iterate_tier(args, build, make_state, steps_per_call, g,
                         world: int, rep) -> str:
    """The iterate leg's tier (≅ JAX ``stencil2d.py:498-516``): the
    explicit ``--iterate-tier``, else ``ensure_tuned("stencil/tier")`` on
    the leg's context — a cache hit, a sweep on a miss under ``--tune``
    (per-timestep seconds of each candidate, by ``chain_rate``), or the
    dtype's prior — with an RDMA winner this world cannot run resolved to
    the no-RDMA prior. Prints what it resolved and from where."""
    ctx = {"dtype": args.dtype, "n": g["n_glob"], "world": world}
    if args.iterate_tier != "auto":
        tier, source = H.check_tier(args.iterate_tier), "explicit"
    else:
        def measure(cand):
            run_c = build(str(cand))
            sec, st = chain_rate(
                run_c, make_state(g["ghost_width"](str(cand))),
                n_short=2, n_long=6,
            )
            del st
            return sec / steps_per_call(str(cand))  # per timestep

        cached = _tune.lookup("stencil/tier", device_fallback=False, **ctx)
        source = ("cache" if cached is not None else
                  "sweep" if _tune.tuning_enabled() else "prior")
        tier = str(ensure_tuned(
            "stencil/tier", measure,
            candidates=H.stencil_tier_candidates(args.dtype),
            prior=H.resolve_stencil_tier(None, **ctx),
            device_fallback=False, **ctx,
        ))
        if tier not in H.STENCIL_TIERS:
            tier, source = H.resolve_stencil_tier(None, **ctx), "prior"
        elif tier.startswith("rdma") and H.rdma_refusal() is not None:
            rep.line(f"NOTE stencil/tier {tier} cannot run here "
                     f"({H.rdma_refusal()}); resolved -> "
                     f"{_priors.STENCIL_TIER_NO_RDMA}")
            tier = _priors.STENCIL_TIER_NO_RDMA
    rep.banner(f"TUNE stencil/tier resolved -> {tier} ({source}; "
               f"blocks={g['n_blocks']})")
    return tier


def field_bits(z: torch.Tensor) -> int:
    """A checksum of ``z``'s bit patterns (their sum as integers, on the
    device): two runs whose fields differ in any bit all but surely
    differ here. The iterate leg's ``iterate_gate`` record carries it, so
    that runs of one schedule can be held equal bit for bit."""
    ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}[
        z.element_size()]
    return int(torch.sum(z.contiguous().view(ints), dtype=torch.int64))


def _all_ranks_agree(ok: bool) -> bool:
    """``ok`` on every rank (a count of the ranks where it fails)."""
    return C.reduce_sum([0.0 if ok else 1.0]) == 0.0


def _state_size(state) -> tuple[int, int]:
    """(points, bytes a point) of a runner's state: a field, or the
    blocks of the resident-block tier."""
    ts = [state] if isinstance(state, torch.Tensor) else [
        t for t in state if isinstance(t, torch.Tensor)]
    return sum(t.numel() for t in ts), ts[0].element_size()


def _iterate_tier_test(args, topo, rep) -> int:
    """The kernel-tier iterate leg: resolve ``stencil/tier`` (``auto``:
    explicit > cached > prior; under ``--tune`` a cache miss sweeps the
    tiers first, each candidate timed by a chain of CUDA graph replays,
    a tier the world cannot run declined with its reason), time the
    exchange + update hot loop under it, then run the honesty checks of
    the JAX driver (``drivers/stencil2d.py:471``):

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
    tier = resolve_iterate_tier(args, build, make_state, steps_per_call, g,
                                world, rep)

    gw = g["ghost_width"](tier)
    run = build(tier)
    if telemetry.registry().enabled:
        # the first call's cost (telemetry runs only: the state is a
        # second field of the run's size), on a state of its own: the
        # field read and written once a timestep, 5 multiply-adds a point
        field = make_state(gw)
        n_pts, item = _state_size(field)
        costs.compile_probe(run, lambda: (field, 1),
                            label="stencil2d_iterate",
                            flops=10 * n_pts * steps_per_call(tier),
                            bytes_accessed=2 * n_pts * item
                            * steps_per_call(tier), kernel=tier)
        del field
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
    same, skipped = False, None
    try:
        fused, chained = build("rdma-fused"), build("rdma-chained")
        za = C.host_value(block(fused(make_state(), args.iterate_iters)))
        zb = C.host_value(block(chained(make_state(), args.iterate_iters)))
        same = bool(np.array_equal(za, zb))
    except ValueError as e:
        skipped = e
    # the agreement is a reduction over ranks: every rank enters it, one
    # whose runners raised too (a skip votes no failure)
    agree = _all_ranks_agree(same or skipped is not None)
    if skipped is not None:
        rep.line(f"NOTE fused/chained bitwise gate skipped ({skipped})")
    elif agree:
        rep.line(f"ITER BITWISE fused==chained over "
                 f"{args.iterate_iters} calls: OK")
    else:
        d = np.abs(za.astype(np.float64) - zb.astype(np.float64))
        rep.line(f"ITER BITWISE FAIL: fused and chained tiers diverge "
                 f"(max |d|={np.nanmax(d):.8g} on rank "
                 f"{topo.process_index})")
        rc = 1

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
    rep.line(f"ITER ERR rel={rel:e} (gate {tol:e})",
             {"kind": "iterate_gate", "tier": tier, "rel": rel, "tol": tol,
              "bits": field_bits(z[gw:gw + args.n_local])})
    if not np.isfinite(rel) or rel > tol:
        rep.line(f"ITER FAIL rel={rel:.8g} > tol {tol:.8g}")
        rc = 1

    # kernel-level overlap record: the fused runner against its
    # compute-only twin (same kernel, the exchange compiled out)
    skipped = None
    try:
        fused = build("rdma-fused")
        comp = H.iterate_fused_rdma_fn(K, g["se"], steps=steps,
                                       periodic=True, local_only=True)
        zf = block(fused(make_state(), 1))  # warm
        zc = block(comp(make_state(), 1))
    except ValueError as e:
        skipped = e
    # every rank enters the barrier, one whose probe raised too
    C.barrier(topo.device)
    if skipped is not None:
        rep.line(f"NOTE fused overlap probe skipped ({skipped})")
        return rc
    try:
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
            f"dtype={args.dtype} managed={args.managed} "
            f"device={topo.device_kinds[0]} kernel={args.kernel} "
            f"rdma={args.rdma}"
        )
        rc = 0
        if args.iterate_tier != "off":
            rc |= _iterate_tier_test(args, topo, rep)
            if args.iterate_only:
                return rc
        if args.kernel == "auto":
            # resolved AFTER the iterate leg, so a same-run sweep's
            # winner is what the matrix legs apply (≅ JAX :667)
            args.kernel = _common.resolve_kernel_auto(
                args.dtype, args.n_local * world, world, rep)
        spaces = ["device"] + (["managed"] if args.managed else [])
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
                for space in spaces:
                    rc |= _deriv_test(args, topo, rep, dim, buf, space)
        for dim in (0, 1):
            if only is not None and not any(d == dim for d, _ in only):
                continue
            for space in spaces:
                rc |= _sum_test(args, topo, rep, dim, space)
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
    p.add_argument("--kernel", default="torch",
                   choices=["torch", "hand", "auto"],
                   help="derivative implementation: torch ops (≅ gtensor / "
                   "the XLA tier), the hand CUDA kernel (≅ the SYCL "
                   "kernel / --kernel pallas), or auto: the stencil/tier "
                   "resolution mapped onto the two (xla -> torch, every "
                   "hand tier -> hand)")
    p.add_argument("--managed", action="store_true",
                   help="add managed-space twins to the matrix (≅ "
                   "-DTEST_MANAGED): the field starts in pinned host memory "
                   "and moves to the device on its first use")
    p.add_argument("--fused", action="store_true",
                   help="time exchange + torch-op stencil as one callable "
                   "per iteration (the fused side of the split-vs-fused "
                   "A/B); default times the exchange alone with the "
                   "stencil executing untimed between iterations (≅ "
                   "mpi_stencil2d_gt.cc:511-535)")
    p.add_argument("--debug-dump", action="store_true",
                   help="print each rank's ghost+edge rows after the "
                   "exchange (≅ the DEBUG halo dumps, "
                   "mpi_stencil2d_sycl_oo.cc:636-659)")
    p.add_argument("--rdma", action="store_true",
                   help="use the hand RDMA ring (hand.ring_halo) for every "
                   "exchange (≅ the SYCL hand-kernel variant of the "
                   "matrix)")
    p.add_argument("--iterate-tier", default="off",
                   choices=["off", "auto", *H.STENCIL_TIERS],
                   help="run the iterate leg under the named tier (auto = "
                   "the stencil/tier cache winner, else the dtype's prior; "
                   "--tune sweeps the space on a miss), with the "
                   "fused-vs-chained bitwise gate, the analytic eigen gate "
                   "and the fused tier's OVERLAP record")
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
    if args.fused and args.kernel != "torch":
        p.error("--fused runs the torch-op stencil inside the exchange "
                "callable; it does not support --kernel hand")
    if args.fused and args.rdma:
        p.error("--fused supports only DIRECT/DEVICE_STAGED exchanges; "
                "combining it with --rdma would skip the whole matrix")
    return _common.run_guarded(run, args)


if __name__ == "__main__":
    sys.exit(main())

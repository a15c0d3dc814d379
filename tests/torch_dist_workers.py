"""Spawned gloo worlds for the port's multi-rank tests (not a test file).

``spawn(suite, world, out_dir)`` starts ``world`` processes with
``torch.multiprocessing.spawn``, each joining a gloo process group through
a ``file://`` rendezvous in ``out_dir``, and runs the named suite in every
rank. A suite runs many cases in the one world and writes each rank's
result to ``out_dir`` as ``<case>.r<rank>.npy`` (or ``.txt`` for driver
output); the test process puts the blocks together and holds them against
the JAX package on a ``world``-device mesh.

Spawning pickles the target by module, so this module imports only numpy,
torch and the port: a worker defined in a test file would import jax and
``conftest`` into every rank. Inputs are made from a seed with numpy, here
and in the tests alike (:func:`global_field`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import traceback

import numpy as np
import torch
import torch.distributed as tdist
import torch.multiprocessing as mp

#: the iterate update scale every runner case uses
SE = 0.05


def global_field(seed: int, shape, dtype=np.float64) -> np.ndarray:
    """The global input of a case (every rank and the test make it)."""
    return np.random.default_rng(seed).normal(size=shape).astype(dtype)


def block_of(a: np.ndarray, world: int, rank: int, axis: int = 0):
    """Rank ``rank``'s block of a global array split along ``axis``."""
    return np.split(a, world, axis=axis)[rank]


def join(out_dir: str, case: str, world: int, axis: int = 0) -> np.ndarray:
    """The ranks' saved blocks of ``case`` concatenated along ``axis``."""
    return np.concatenate([np.load(os.path.join(out_dir,
                                                f"{case}.r{r}.npy"))
                           for r in range(world)], axis=axis)


def load_rank(out_dir: str, case: str, rank: int):
    return np.load(os.path.join(out_dir, f"{case}.r{rank}.npy"))


def read_text(out_dir: str, case: str, rank: int) -> str:
    with open(os.path.join(out_dir, f"{case}.r{rank}.txt")) as f:
        return f.read()


# ---------------------------------------------------------------------------
# the cases (shared by the workers and the tests)
# ---------------------------------------------------------------------------

#: halo_exchange: (staging, axis, periodic, ndim)
EXCHANGE_CASES = [(st, ax, per, nd)
                  for st in ("direct", "device", "host", "pallas")
                  for per in (False, True)
                  for ax, nd in ((0, 2), (1, 2), (0, 1))]
#: iterate_fused_fn: (axis, periodic)
FUSED_CASES = [(ax, per) for ax in (0, 1) for per in (False, True)]
#: iterate_hand_fn: (axis, steps, periodic, rdma)
HAND_CASES = [(ax, st, per, rdma) for ax in (0, 1) for st in (1, 2)
              for per in (False, True) for rdma in (False, True)]
#: iterate_hand_blocks_fn: (n_blocks, periodic)
SPLIT_CASES = [(s, per) for s in (2, 3) for per in (False, True)]
#: iterate_fused_rdma_fn: (steps, periodic, dtype, nloc, tile_rows)
FUSED_RDMA_CASES = [
    (1, False, "float32", 16, 16), (1, True, "float32", 16, 16),
    (4, False, "float32", 16, 16), (4, True, "float32", 16, 16),
    (1, False, "float32", 36, 8), (1, True, "bfloat16", 20, None),
]


def exchange_name(st, ax, per, nd):
    return f"exchange_{st}_ax{ax}_p{int(per)}_{nd}d"


def exchange_shape(world, ax, nd):
    if nd == 1:
        return (world * 12,)
    return (world * 12, 10) if ax == 0 else (10, world * 12)


def exchange_seed(st, ax, per, nd):
    return 100 + 10 * ax + 2 * per + nd


def hand_shape(world, ax, steps):
    K = 2 * steps
    return (world * (12 + 2 * K), 10) if ax == 0 else \
        (10, world * (12 + 2 * K))


# ---------------------------------------------------------------------------
# process plumbing
# ---------------------------------------------------------------------------


def _entry(rank, world, out_dir, suite):
    # one thread a rank, at low priority: the ranks share the host with
    # the rest of the test run, whose timing legs they must not starve
    torch.set_num_threads(1)
    os.nice(10)
    tdist.init_process_group("gloo",
                             init_method=f"file://{out_dir}/rendezvous",
                             rank=rank, world_size=world)
    from tpu_mpi_tests_torch.comm import dist, peer

    try:
        dist.init(SUITE_DEVICES.get(suite, "cpu"))
        SUITES[suite](rank, world, out_dir)
    except BaseException:
        with open(os.path.join(out_dir, f"error.r{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        peer.reset()
        dist.shutdown()


def spawn(suite: str, world: int, out_dir: str) -> str:
    """Run ``suite`` in a fresh gloo world of ``world`` ranks; returns
    ``out_dir``. A rank that raised leaves ``error.r<rank>.txt``."""
    out_dir = str(out_dir)
    os.makedirs(out_dir, exist_ok=True)
    mp.spawn(_entry, args=(world, out_dir, suite), nprocs=world, join=True)
    return out_dir


def _save(out_dir, case, rank, value):
    if isinstance(value, torch.Tensor):
        value = value.detach()
        if value.dtype == torch.bfloat16:
            value = value.float()
        value = value.cpu().numpy()
    np.save(os.path.join(out_dir, f"{case}.r{rank}.npy"), np.asarray(value))


def _run_main(out_dir, case, rank, main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    with open(os.path.join(out_dir, f"{case}.r{rank}.txt"), "w") as f:
        f.write(f"RC {rc}\n" + buf.getvalue())


# ---------------------------------------------------------------------------
# suites
# ---------------------------------------------------------------------------


def _tensor(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def suite_dist(rank, world, out_dir):
    """World checks, exchanges, collectives, the torch and hand runners,
    the drivers."""
    from tpu_mpi_tests_torch.comm import collectives as C
    from tpu_mpi_tests_torch.comm import dist
    from tpu_mpi_tests_torch.comm import halo as H
    from tpu_mpi_tests_torch.comm.mesh import topology

    w = dist.world()
    topo = topology(torch.device("cpu"))
    with open(os.path.join(out_dir, f"world.r{rank}.txt"), "w") as f:
        json.dump({"rank": w.rank, "size": w.size, "backend": w.backend,
                   "hosts": w.hosts, "ranks_per_host": w.ranks_per_host,
                   "process_index": topo.process_index,
                   "global_device_count": topo.global_device_count}, f)

    for st, ax, per, nd in EXCHANGE_CASES:
        if st == "pallas":
            continue  # tests/test_torch_rdma.py
        g = global_field(exchange_seed(st, ax, per, nd),
                         exchange_shape(world, ax, nd))
        z = _tensor(block_of(g, world, rank, ax)).clone()
        z = H.halo_exchange(z, axis=ax, n_bnd=2, periodic=per, staging=st)
        _save(out_dir, exchange_name(st, ax, per, nd), rank, z)
        if st == "device" and nd == 2:
            zh = _tensor(block_of(g, world, rank, ax)).clone()
            zh = H.halo_exchange(zh, axis=ax, n_bnd=2, periodic=per,
                                 staging=st, kernel="hand")
            _save(out_dir, exchange_name("hand", ax, per, nd), rank, zh)

    for ax, per in FUSED_CASES:
        g = global_field(7 + ax, (world * 16, 12) if ax == 0 else
                         (12, world * 16))
        run = H.iterate_fused_fn(ax, 2, 4.0, 1e-2, periodic=per)
        _save(out_dir, f"fused_ax{ax}_p{int(per)}", rank,
              run(_tensor(block_of(g, world, rank, ax)).clone(), 5))

    for ax, steps, per, rdma in HAND_CASES:
        if rdma:
            continue  # tests/test_torch_rdma.py
        g = global_field(20 + steps, hand_shape(world, ax, steps))
        run = H.iterate_hand_fn(2 * steps, SE, axis=ax, steps=steps,
                                periodic=per)
        _save(out_dir, f"hand_ax{ax}_s{steps}_p{int(per)}", rank,
              run(_tensor(block_of(g, world, rank, ax)).clone(), 3))

    for S, per in SPLIT_CASES:
        K = 4
        g = global_field(30 + S, (world * (S * 6 + 2 * K), 12))
        run = H.iterate_hand_blocks_fn(S, K, SE, steps=2, periodic=per)
        z = _tensor(block_of(g, world, rank)).clone()
        out = H.merge_blocks(run(H.split_blocks(z, S, K), 3), K)
        _save(out_dir, f"blocks_S{S}_p{int(per)}", rank, out)

    # collectives
    g = global_field(40, (world * 6, 5))
    mine = C.shard_1d(g, torch.device("cpu"))
    _save(out_dir, "shard_1d", rank, mine)
    _save(out_dir, "shard_1d_ax1", rank,
          C.shard_1d(global_field(41, (5, world * 6)), "cpu", axis=1))
    _save(out_dir, "all_gather", rank, C.all_gather(mine))
    _save(out_dir, "all_gather_ax1", rank,
          C.all_gather(mine.T.contiguous(), axis=1))
    allx = torch.zeros(world * 6, 5, dtype=torch.float64)
    allx[rank * 6:(rank + 1) * 6] = mine
    _save(out_dir, "all_gather_inplace", rank, C.all_gather_inplace(allx))
    row = torch.from_numpy(global_field(42, (world, 7))[rank:rank + 1]).clone()
    _save(out_dir, "allreduce_sum", rank, C.allreduce_sum(row))
    _save(out_dir, "per_rank_sums", rank, C.per_rank_sums(mine))
    _save(out_dir, "per_rank_sums_g2", rank,
          C.per_rank_sums(mine, groups_per_shard=2))
    other = C.shard_1d(global_field(43, (world * 6, 5)), "cpu")
    _save(out_dir, "per_rank_err_norms", rank,
          C.per_rank_err_norms(mine, other))
    _save(out_dir, "reduce_sum", rank,
          np.array([C.reduce_sum([0.25 * rank, 1.0])]))
    _save(out_dir, "replicate", rank,
          C.replicate(global_field(44 + rank, (3, 4)), "cpu"))
    blocks = C.shard_blocks((world * 4, 3), torch.float64,
                            lambda r: np.full((4, 3), float(r + 1)), "cpu")
    _save(out_dir, "shard_blocks", rank, blocks)
    _save(out_dir, "device_init", rank,
          C.device_init(lambda r: torch.full((2,), float(10 * r))))
    C.barrier(torch.device("cpu"))

    from tpu_mpi_tests_torch.drivers import stencil1d, stencil2d

    _run_main(out_dir, "driver_stencil2d", rank, stencil2d.main,
              ["--device", "cpu", "--n-local", "24", "--n-other", "16",
               "--n-iter", "2", "--n-warmup", "1", "--dtype", "float64",
               "--iterate-tier", "rdma-fused", "--iterate-steps", "2",
               "--iterate-iters", "3"])
    for st in ("direct", "device", "host"):
        _run_main(out_dir, f"driver_stencil1d_{st}", rank, stencil1d.main,
                  ["--device", "cpu", "--n-global", str(4096 * world),
                   "--dtype", "float64", "--staging", st])


def suite_rdma(rank, world, out_dir):
    """The hand RDMA ring's plain versions over gloo: the pallas
    exchange, the chained and the fused tier, the drivers' RDMA legs."""
    from tpu_mpi_tests_torch import bench
    from tpu_mpi_tests_torch.comm import halo as H
    from tpu_mpi_tests_torch.comm import peer

    for st, ax, per, nd in EXCHANGE_CASES:
        if st != "pallas":
            continue
        g = global_field(exchange_seed(st, ax, per, nd),
                         exchange_shape(world, ax, nd))
        z = H.staging_buffer(_tensor(block_of(g, world, rank, ax)), st)
        z = H.halo_exchange(z, axis=ax, n_bnd=2, periodic=per, staging=st)
        _save(out_dir, exchange_name(st, ax, per, nd), rank, z)

    for ax, steps, per, rdma in HAND_CASES:
        if not rdma:
            continue
        g = global_field(20 + steps, hand_shape(world, ax, steps))
        run = H.iterate_hand_fn(2 * steps, SE, axis=ax, steps=steps,
                                periodic=per, rdma=True)
        _save(out_dir, f"rdma_ax{ax}_s{steps}_p{int(per)}", rank,
              run(_tensor(block_of(g, world, rank, ax)).clone(), 3))

    for i, (steps, per, dt, nloc, tile) in enumerate(FUSED_RDMA_CASES):
        K = 2 * steps
        g = global_field(50 + i, (world * (nloc + 2 * K), 32),
                         dtype=np.float32)
        z = _tensor(block_of(g, world, rank)).to(getattr(torch, dt))
        fused = H.iterate_fused_rdma_fn(K, 1e-2, steps=steps, periodic=per,
                                        tile_rows=tile)
        chained = H.iterate_hand_fn(K, 1e-2, axis=0, steps=steps,
                                    periodic=per, rdma=True)
        _save(out_dir, f"fused_rdma_{i}", rank, fused(z.clone(), 3))
        _save(out_dir, f"chained_rdma_{i}", rank, chained(z.clone(), 3))

    # the runners' peer-memory pairs: a fresh input takes a new pair, a
    # runner's own result reuses its pair, and a pair is freed with the
    # last result that views it
    ring = peer.peer_ring(torch.device("cpu"))
    z = _tensor(block_of(global_field(59, (world * 24, 32), np.float32),
                         world, rank))
    counts = [len(ring._allocs)]
    for run in (H.iterate_fused_rdma_fn(4, 1e-2, steps=2, periodic=True),
                H.iterate_hand_fn(4, 1e-2, axis=0, steps=2, periodic=True,
                                  rdma=True)):
        for _ in range(2):
            out = run(z.clone(), 2)
            again = run(out, 2)
            same = (again.untyped_storage().data_ptr()
                    == out.untyped_storage().data_ptr())
            counts += [len(ring._allocs), int(same)]
            del out, again
            counts.append(len(ring._allocs))
    _save(out_dir, "pair_allocs", rank, np.array(counts))

    from tpu_mpi_tests_torch.drivers import stencil1d, stencil2d

    for tier in ("rdma-chained", "rdma-fused"):
        _run_main(out_dir, f"driver_stencil2d_{tier}", rank, stencil2d.main,
                  ["--device", "cpu", "--n-local", "24", "--n-other", "16",
                   "--n-iter", "2", "--n-warmup", "1", "--dtype", "float32",
                   "--rdma", "--iterate-tier", tier, "--iterate-steps", "1",
                   "--iterate-iters", "3"])
    _run_main(out_dir, "driver_stencil1d_pallas", rank, stencil1d.main,
              ["--device", "cpu", "--n-global", str(4096 * world),
               "--dtype", "float64", "--staging", "pallas"])
    env = {"TPU_MPI_BENCH_N": "64", "TPU_MPI_BENCH_ITERS_SHORT": "8",
           "TPU_MPI_BENCH_ITERS_LONG": "24", "TPU_MPI_BENCH_SAMPLES": "1",
           "TPU_MPI_BENCH_SECOND_DTYPE": "none"}
    os.environ.update(env)
    for tier in ("rdma-chained", "rdma-fused"):
        os.environ["TPU_MPI_BENCH_TIER"] = tier
        _run_main(out_dir, f"bench_{tier}", rank,
                  lambda argv: json.dumps(bench.main(argv)), ["--device",
                                                               "cpu"])
    os.environ["TPU_MPI_BENCH_N"] = "65"  # not a multiple of the world
    got = _error_text(bench.main, ["--device", "cpu"])
    with open(os.path.join(out_dir, f"bench_n65.r{rank}.txt"), "w") as f:
        f.write(got)


def _error_text(fn, *args) -> str:
    """The text of the ``TpuMtError`` that ``fn(*args)`` raises, or "no
    error"."""
    from tpu_mpi_tests_torch.utils import TpuMtError

    try:
        fn(*args)
    except TpuMtError as e:
        return str(e)
    return "no error"


#: the collectives' shard cases: (name, global shape, dtype); the 1-D and
#: 2-D shapes meet the JAX kernels' tile floors at worlds 2 and 4, the
#: "small" ones only the port's n % w rule
COLL_CASES = [
    ("1d", (8192,), "float32"), ("1d_bf16", (16384,), "bfloat16"),
    ("2d", (4 * 64, 8), "float32"), ("2d_bf16", (4 * 64, 8), "bfloat16"),
    ("small_1d", (4 * 12,), "float32"), ("small_2d", (4 * 5, 3), "float64"),
]
#: one-shot row lengths: a full row and the decode payloads
ONESHOT_ROWS = (4096, 8, 4)
#: collbench's ladder in the multi-rank runs (small: cheap chains)
COLL_SIZES_KIB = "64,1024"


def coll_shard(case, world, rank):
    """This rank's shard of a collectives case: the global array is
    ``world`` copies of the case's shape stacked, each rank taking one."""
    i = [c[0] for c in COLL_CASES].index(case)
    _, shape, dt = COLL_CASES[i]
    g = global_field(200 + i, (world,) + shape, dtype=np.float32)
    if dt == "float64":
        g = global_field(200 + i, (world,) + shape)
    return g, torch.from_numpy(np.ascontiguousarray(g[rank])).to(
        getattr(torch, dt))


def suite_coll(rank, world, out_dir):
    """The collective kernels' plain versions and tiers over gloo, the
    collbench and gather_inplace drivers, and the stencil2d --rdma
    allreduce leg."""
    from tpu_mpi_tests_torch.comm import collectives as C
    from tpu_mpi_tests_torch.kernels import hand

    for case, _, _ in COLL_CASES:
        _, x = coll_shard(case, world, rank)
        _save(out_dir, f"ag_{case}", rank, hand.ring_allgather(x))
        for credits in (1, 2):
            _save(out_dir, f"rs_{case}_c{credits}", rank,
                  hand.ring_reduce_scatter(x, credits=credits))
            _save(out_dir, f"ar_{case}_c{credits}", rank,
                  hand.ring_allreduce(x, credits=credits))
        _save(out_dir, f"os_gather_{case}", rank, hand.oneshot_allgather(x))
        _save(out_dir, f"os_sum_{case}", rank, hand.oneshot_allreduce(x))
    # the world simulation of the plain versions, run on every rank's
    # shards in one process (the card's cross-wired check uses it)
    for case, _, dt in COLL_CASES[:3]:
        g, _ = coll_shard(case, world, rank)
        shards = [torch.from_numpy(np.ascontiguousarray(b)).to(
            getattr(torch, dt)) for b in g]
        for name in ("ring_allgather", "ring_reduce_scatter",
                     "oneshot_allgather", "oneshot_allreduce"):
            _save(out_dir, f"world_ref_{name}_{case}", rank,
                  hand.coll_world_ref(name, shards)[rank])

    # the tiers on (1, L) rows
    for L in ONESHOT_ROWS:
        row = torch.from_numpy(global_field(300 + L, (world, L),
                                            np.float32)[rank:rank + 1])
        _save(out_dir, f"allreduce_oneshot_{L}", rank,
              C.allreduce_oneshot(row))
        _save(out_dir, f"all_gather_oneshot_{L}", rank,
              C.all_gather_oneshot(row[0]))
    def ints():  # this rank's integer-valued (1, 8·world) row
        return torch.from_numpy(
            np.arange(world * 8 * world, dtype=np.float32)
            .reshape(world, 8 * world)[rank:rank + 1] % 13)

    _save(out_dir, "reduce_scatter_sum", rank, C.reduce_scatter_sum(ints()))
    for credits in (1, 2):
        _save(out_dir, f"allreduce_rdma_c{credits}", rank,
              C.allreduce_rdma(ints(), credits=credits))
    _save(out_dir, "all_gather_rdma", rank, C.all_gather_rdma(ints()[0]))
    errors = []
    for call in (lambda: C.allreduce_rdma(ints().repeat(2, 1)),
                 lambda: C.allreduce_oneshot(ints()[0]),
                 lambda: C.reduce_scatter_sum(ints().repeat(2, 1)),
                 lambda: hand.ring_reduce_scatter(torch.ones(4 * world + 1)),
                 lambda: C.allreduce_rdma(torch.ones(1, 4 * world + 1))):
        try:
            call()
            errors.append("no error")
        except ValueError as e:
            errors.append(f"{type(e).__name__}: {e}")
    with open(os.path.join(out_dir, f"errors.r{rank}.txt"), "w") as f:
        f.write("\n".join(errors))

    from tpu_mpi_tests_torch.drivers import collbench, gather_inplace, stencil2d

    names = ",".join(collbench.COLLECTIVES + collbench.COLLECTIVES_RDMA
                     + collbench.COLLECTIVES_ONESHOT)
    _run_main(out_dir, "collbench", rank, collbench.main,
              ["--device", "cpu", "--collectives", names, "--sizes-kib",
               COLL_SIZES_KIB, "--n-iter", "10", "--jsonl",
               os.path.join(out_dir, "collbench.jsonl")])
    _run_main(out_dir, "collbench_c2", rank, collbench.main,
              ["--device", "cpu", "--collectives", "allreduce_rdma",
               "--sizes-kib", "64", "--n-iter", "10", "--rdma-credits", "2"])
    for rdma in (False, True):
        _run_main(out_dir, f"gather_inplace_rdma{int(rdma)}", rank,
                  gather_inplace.main,
                  ["--device", "cpu", "--n-per-rank", "1024", "--dtype",
                   "float64"] + (["--rdma"] if rdma else []))

    # stencil2d --rdma: the allreduce leg goes through allreduce_rdma
    calls = []
    real = C.allreduce_rdma

    def counted(per_rank, credits=1):
        calls.append(per_rank.shape)
        return real(per_rank, credits)

    C.allreduce_rdma = counted
    try:
        _run_main(out_dir, "stencil2d_rdma", rank, stencil2d.main,
                  ["--device", "cpu", "--n-local", "24", "--n-other", "16",
                   "--n-iter", "2", "--n-warmup", "1", "--dtype", "float64",
                   "--rdma"])
    finally:
        C.allreduce_rdma = real
    with open(os.path.join(out_dir, f"stencil2d_rdma_calls.r{rank}.txt"),
              "w") as f:
        f.write(str(len(calls)))
    # a row the world does not divide: the library tier, with the NOTE
    _run_main(out_dir, "stencil2d_rdma_note", rank, stencil2d.main,
              ["--device", "cpu", "--n-local", "24", "--n-other",
               str(4 * world + 1), "--n-iter", "2", "--n-warmup", "1",
               "--dtype", "float64", "--rdma"])


#: ring attention: (flash, causal, stripe) layouts, and the cases
#: (flash, causal, stripe, depth) running each at depth 1, 2 and 4 (4 is
#: clamped to the world at 2 ranks)
RING_LAYOUTS = [(flash, causal, stripe) for flash in (False, True)
                for causal, stripe in ((False, False), (True, False),
                                       (True, True))]
RING_CASES = [layout + (depth,) for layout in RING_LAYOUTS
              for depth in (1, 2, 4)]
#: the sequence per rank and the head width of the ring cases
RING_L_LOCAL, RING_D = 16, 16
#: Ulysses: (form, block_keys, flash) × causal; heads per rank
ULYSSES_FORMS = (("full", 512, False), ("blockwise", 8, False),
                 ("flash", 512, True))
ULYSSES_HEADS_PER_RANK = 2


def ring_global(seed: int, world: int, stripe: bool = False,
                heads: "int | None" = None, dtype=np.float32):
    """The global q, k, v of a ring (or, with ``heads``, Ulysses) case:
    (world·L_local, d), or (world·L_local, heads, d); striped when
    asked (``comm.ring.to_striped``'s permutation)."""
    L = world * RING_L_LOCAL
    shape = (L, RING_D) if heads is None else (L, heads, RING_D)
    qkv = [global_field(seed + i, shape, dtype) for i in range(3)]
    if stripe:
        lloc = L // world
        qkv = [t.reshape((lloc, world) + t.shape[1:]).swapaxes(0, 1)
               .reshape(t.shape) for t in qkv]
    return qkv


def ring_case(flash, causal, stripe, depth, dtype="float32"):
    return (f"ring_{'flash' if flash else 'xla'}_c{int(causal)}"
            f"_s{int(stripe)}_d{depth}_{dtype}")


def ring_seed(causal, stripe):
    return 500 + 10 * causal + 20 * stripe


def _run_main_both(out_dir, case, rank, main, argv):
    """:func:`_run_main` with stderr (the NOTE lines) kept after an
    ``ERR`` marker line."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    with open(os.path.join(out_dir, f"{case}.r{rank}.txt"), "w") as f:
        f.write(f"RC {rc}\n" + out.getvalue() + "ERR\n" + err.getvalue())


def suite_ring(rank, world, out_dir):
    """Ring and Ulysses attention over gloo: the torch-op and flash tiers
    at depth 1, 2 and 4, the fused tier (the kernel's plain version), the
    all-to-all reshards, the refusals and attnbench."""
    from tpu_mpi_tests_torch.comm import alltoall as A
    from tpu_mpi_tests_torch.comm import ring as R
    from tpu_mpi_tests_torch.comm.mesh import MeshError
    from tpu_mpi_tests_torch.kernels import hand

    def blocks(arrs, dt=torch.float32):
        return [_tensor(block_of(a, world, rank)).to(dt) for a in arrs]

    for flash, causal, stripe, depth in RING_CASES:
        qkv = blocks(ring_global(ring_seed(causal, stripe), world, stripe))
        attn = R.ring_attention_fn(world, causal=causal, flash=flash,
                                   stripe=stripe, depth=depth)
        _save(out_dir, ring_case(flash, causal, stripe, depth), rank,
              attn(*qkv))
    for flash, causal, stripe in RING_LAYOUTS:
        if flash:
            for dt in ("float32", "bfloat16"):
                tq = blocks(ring_global(ring_seed(causal, stripe), world,
                                        stripe), getattr(torch, dt))
                _save(out_dir, f"fused_c{int(causal)}_s{int(stripe)}_{dt}",
                      rank, R.ring_attention_fn(
                          world, causal=causal, stripe=stripe,
                          tier="fused")(*tq))
                _save(out_dir, f"pipelined_c{int(causal)}_s{int(stripe)}_"
                      f"{dt}", rank, R.ring_attention_fn(
                          world, causal=causal, stripe=stripe, flash=True,
                          tier="pipelined")(*tq))
                # the world simulation the card's cross-wired check uses
                g = ring_global(ring_seed(causal, stripe), world, stripe)
                every = [[_tensor(block_of(a, world, r)).to(
                    getattr(torch, dt)) for a in g] for r in range(world)]
                _save(out_dir, f"fused_world_ref_c{int(causal)}_"
                      f"s{int(stripe)}_{dt}", rank, hand.fused_ring_world_ref(
                          every, causal=causal, stripe=stripe)[rank])
    for flash in (False, True):  # bfloat16, contiguous causal, depth 1
        qkv = blocks(ring_global(ring_seed(True, False), world),
                     torch.bfloat16)
        _save(out_dir, ring_case(flash, True, False, 1, "bfloat16"), rank,
              R.ring_attention_fn(world, causal=True, flash=flash)(*qkv))

    heads = ULYSSES_HEADS_PER_RANK * world
    for form, block_keys, flash in ULYSSES_FORMS:
        for causal in (False, True):
            qkv = blocks(ring_global(600 + 10 * causal, world, heads=heads))
            _save(out_dir, f"ulysses_{form}_c{int(causal)}", rank,
                  A.ulysses_attention_fn(world, causal=causal,
                                         block_keys=block_keys,
                                         flash=flash)(*qkv))
    x = blocks(ring_global(700, world, heads=heads))[0]
    sh = A.seq_to_heads(x, world)
    _save(out_dir, "seq_to_heads", rank, sh)
    _save(out_dir, "heads_to_seq", rank, A.heads_to_seq(sh, world))
    _save(out_dir, "seq_to_heads_bf16", rank,
          A.seq_to_heads(x.to(torch.bfloat16), world))

    errors = []
    q = torch.zeros(RING_L_LOCAL, RING_D)
    for call in (lambda: R.ring_attention(q, q, q, world=world + 1),
                 lambda: A.ulysses_attention_fn(world=2 * world),
                 lambda: R.ring_attention(q, q, q, stripe=True, world=world),
                 lambda: hand.fused_ring_attention(q, q, q, stripe=True),
                 lambda: hand.fused_ring_attention(q, q, q, self_ring=2),
                 lambda: A.seq_to_heads(torch.zeros(4, world + 1, 2),
                                        world)):
        try:
            call()
            errors.append("no error")
        except (MeshError, ValueError) as e:
            errors.append(f"{type(e).__name__}: {e}")
    with open(os.path.join(out_dir, f"errors.r{rank}.txt"), "w") as f:
        f.write("\n".join(errors))

    from tpu_mpi_tests_torch.drivers import attnbench

    argv = ["--device", "cpu", "--seq-len", str(RING_L_LOCAL * world),
            "--head-dim", str(RING_D), "--n-iter", "10",
            "--tiers", "ring,ulysses"]
    _run_main_both(out_dir, "attnbench", rank, attnbench.main,
                   argv + ["--jsonl", os.path.join(out_dir, "a.jsonl")])
    _run_main_both(out_dir, "attnbench_fused", rank, attnbench.main,
                   argv + ["--ring-tier", "fused", "--ring-depth", "2",
                           "--causal", "--stripe", "--jsonl",
                           os.path.join(out_dir, "f.jsonl")])
    real = hand.fused_ring_feasible
    hand.fused_ring_feasible = lambda *a, **k: False
    try:
        _run_main_both(out_dir, "attnbench_declined", rank, attnbench.main,
                       argv[:-1] + ["ring", "--ring-tier", "fused"])
    finally:
        hand.fused_ring_feasible = real


def suite_symm_one_card(rank, world, out_dir):
    """Every rank on card 0 asks for the RDMA kernels' peer memory: the
    symmetric-memory rendezvous refuses ranks that share a card, and the
    peer layer raises (no fallback). Writes what it got."""
    from tpu_mpi_tests_torch.comm import peer

    try:
        peer.peer_ring(torch.device("cuda", 0))
        got = "OK"
    except peer.PeerError as e:
        got = f"PeerError: {e}"
    with open(os.path.join(out_dir, f"symm.r{rank}.txt"), "w") as f:
        f.write(got)


#: the process grids of each world: (px, py)
GRIDS = {2: ((1, 2), (2, 1)), 4: ((2, 2),)}
#: the grid cases' block interiors and coefficients
GRID_NXL, GRID_NYL = 12, 10
HEAT_CX, HEAT_CY = 0.1, 0.2
GRID_SX, GRID_SY = 1.5, 0.75
#: heat_step2d_fn's ghost widths (steps = n_bnd) and outer bodies
HEAT_STEPS, HEAT_BODIES = (1, 2, 4), 3
#: the grid drivers' runs: (case, module, argv); every run adds
#: ``--mesh PX,PY`` (its grid) and ``--dtype float64``
GRID_DRIVER_RUNS = (
    ("heat2d_hand_k2", "heat2d",
     ["--kernel", "hand", "--nx-local", "16", "--ny-local", "12",
      "--n-steps", "24", "--halo-steps", "2"]),
    ("heat2d_torch_k1", "heat2d",
     ["--kernel", "torch", "--nx-local", "8", "--ny-local", "16",
      "--n-steps", "30", "--ky", "2"]),
    ("grid_hand", "stencil2d_grid",
     ["--kernel", "hand", "--nx-local", "16", "--ny-local", "24",
      "--n-iter", "3", "--n-warmup", "1"]),
    ("grid_torch", "stencil2d_grid",
     ["--kernel", "torch", "--nx-local", "16", "--ny-local", "24",
      "--n-iter", "3", "--n-warmup", "1"]),
)
#: the DAXPY drivers' runs at every world: (case, module, argv with
#: ``{w}`` for the world size)
DAXPY_RUNS = (
    ("mpi_daxpy", "mpi_daxpy", ["--n-total", "8192", "--dtype", "float64"]),
    ("mpi_daxpy_over", "mpi_daxpy",
     ["--n-total", "8192", "--ranks", "{2w}", "--dtype", "float64"]),
    ("nvtx_host", "mpi_daxpy_nvtx",
     ["--n-per-node", "65536", "--dtype", "float64"]),
    ("nvtx_device", "mpi_daxpy_nvtx",
     ["--n-per-node", "65536", "--dtype", "float64", "--init", "device",
      "--barrier"]),
    ("nvtx_managed", "mpi_daxpy_nvtx",
     ["--n-per-node", "65536", "--dtype", "float32", "--space",
      "managed"]),
    ("daxpy", "daxpy", ["--n", "1000", "--dtype", "float64", "--iters",
                        "2"]),
)


def grid_name(px, py):
    return f"g{px}x{py}"


def heat_global(px, py, k):
    """A heat case's global ghosted layout (the JAX drivers' (px·gxs,
    py·gys), every block ghosted k deep)."""
    return global_field(900 + 10 * k + px,
                        (px * (GRID_NXL + 2 * k), py * (GRID_NYL + 2 * k)))


def step_global(px, py):
    """A grid step case's global layout, every block ghosted 2 deep."""
    return global_field(950 + px, (px * (GRID_NXL + 4), py * (GRID_NYL + 4)))


def daxpy_argv(argv, world):
    return [a.replace("{2w}", str(2 * world)) for a in argv]


def suite_grid(rank, world, out_dir):
    """The 2-D process grids of this world (``GRIDS``): heat_step2d_fn and
    step2d_fn in both tiers, the heat2d and stencil2d_grid drivers, a
    ``--mesh`` the world does not multiply to; the DAXPY drivers and
    spec; the two-level mesh's sums."""
    import importlib
    import socket

    from tpu_mpi_tests_torch.comm import dist
    from tpu_mpi_tests_torch.comm import halo as H
    from tpu_mpi_tests_torch.comm import mesh as M
    from tpu_mpi_tests_torch.convert import grid_block

    for px, py in GRIDS[world]:
        grid = M.make_grid(px, py)
        gn = grid_name(px, py)
        _save(out_dir, f"coords_{gn}", rank,
              np.array([grid.rx, grid.ry, *grid.x.members, *grid.y.members]))
        for k in HEAT_STEPS:
            g = heat_global(px, py, k)
            for kernel in ("torch", "hand"):
                z = _tensor(grid_block(g, px, py, grid.rx, grid.ry)).clone()
                run = H.heat_step2d_fn(k, HEAT_CX, HEAT_CY, steps=k,
                                       kernel=kernel, grid=grid)
                _save(out_dir, f"heat_{gn}_k{k}_{kernel}", rank,
                      run(z, HEAT_BODIES))
        g = step_global(px, py)
        for kernel in ("torch", "hand"):
            z = _tensor(grid_block(g, px, py, grid.rx, grid.ry)).clone()
            dz_dx, dz_dy, res = H.step2d_fn(2, GRID_SX, GRID_SY,
                                            kernel=kernel, grid=grid)(z)
            _save(out_dir, f"step_{gn}_{kernel}_dx", rank, dz_dx)
            _save(out_dir, f"step_{gn}_{kernel}_dy", rank, dz_dy)
            _save(out_dir, f"step_{gn}_{kernel}_res", rank, res.reshape(1))
        for case, name, argv in GRID_DRIVER_RUNS:
            module = importlib.import_module(
                f"tpu_mpi_tests_torch.drivers.{name}")
            _run_main(out_dir, f"driver_{case}_{gn}", rank, module.main,
                      ["--device", "cpu", "--mesh", f"{px},{py}", "--dtype",
                       "float64"] + argv)
    # a grid that does not multiply to the world: the JAX ERROR line
    from tpu_mpi_tests_torch.drivers import heat2d, stencil2d_grid

    bad = f"{world},{world}"
    _run_main(out_dir, "bad_mesh_heat2d", rank, heat2d.main,
              ["--device", "cpu", "--mesh", bad])
    _run_main(out_dir, "bad_mesh_stencil2d_grid", rank, stencil2d_grid.main,
              ["--device", "cpu", "--mesh", bad])
    try:
        M.make_grid(world, world)
        got = "no error"
    except M.MeshError as e:
        got = f"MeshError: {e}"
    with open(os.path.join(out_dir, f"make_grid_bad.r{rank}.txt"), "w") as f:
        f.write(got)

    for case, name, argv in DAXPY_RUNS:
        module = importlib.import_module(f"tpu_mpi_tests_torch.drivers.{name}")
        _run_main(out_dir, f"daxpy_{case}", rank, module.main,
                  ["--device", "cpu"] + daxpy_argv(argv, world))

    # the two-level mesh: the world's own layout (one host), then each
    # rank a host of its own, the layout of the JAX package's
    # two-process test (tests/test_multiproc.py)
    def two_level_sums(tag):
        m = M.make_mesh_2level()
        x = torch.tensor([float(rank)], dtype=torch.float32)
        both = m.psum(x.clone(), ("dcn", "ici"))
        dcn = m.psum(x.clone(), "dcn")
        ici = m.psum(x.clone(), "ici")
        _save(out_dir, f"2level_{tag}", rank,
              np.array([m.dcn.size, m.ici.size, m.dcn.rank, m.ici.rank,
                        float(both[0]), float(dcn[0]), float(ici[0]),
                        float((both + dcn)[0])]))

    two_level_sums("one_host")
    real_name, real_world = socket.gethostname, dist._WORLD
    socket.gethostname = lambda: f"host{rank}"
    try:
        hosts, per, local = dist._host_layout(rank, world)
        dist._WORLD = dataclasses.replace(real_world, hosts=hosts,
                                          ranks_per_host=per,
                                          local_rank=local)
        two_level_sums("host_a_rank")
    finally:
        socket.gethostname, dist._WORLD = real_name, real_world


#: the overlap suite's cases: the pipelines' rounds, the 1-D Jacobi and
#: iterate fields' interiors a rank, the update scale, and the drivers'
#: runs (case, module, argv; the grid drivers add ``--mesh PX,PY``)
OV_ROUNDS, OV_N, OV_EPS, OV_SCALE = 4, 12, 1e-2, 3.0
OV_DRIVER_RUNS = (
    ("heat2d", "heat2d",
     ["--kernel", "torch", "--nx-local", "8", "--ny-local", "12",
      "--n-steps", "12", "--dtype", "float64", "--overlap", "2"]),
    ("grid", "stencil2d_grid",
     ["--kernel", "torch", "--nx-local", "16", "--ny-local", "12",
      "--n-iter", "3", "--n-warmup", "1", "--dtype", "float64",
      "--overlap", "2"]),
)
OV_STENCIL1D_ARGV = ["--n-global", "4096", "--dtype", "float64",
                     "--overlap", "2", "--overlap-iters", "5"]


def ov_jacobi_global(world, periodic):
    """A 1-D Jacobi case's global ghosted layout (the ranks' blocks of
    ``OV_N + 4`` side by side)."""
    return global_field(1300 + world + periodic, (world * (OV_N + 4),))


def ov_iterate_global(world, axis, periodic):
    """An iterate case's global layout, each rank's block ``OV_N + 4``
    along ``axis`` and 10 across."""
    shape = (world * (OV_N + 4), 10) if axis == 0 else (10,
                                                        world * (OV_N + 4))
    return global_field(1400 + 10 * axis + world + periodic, shape)


def suite_overlap(rank, world, out_dir):
    """The overlap engine over the ranks: the three split pipelines at
    depth 1 and 2 beside their serial bodies (the 1-D Jacobi on the
    world ring, periodic and not; heat and the grid step on each grid of
    ``GRIDS``), ``iterate_overlap_fn`` beside ``iterate_hand_fn`` on both
    axes, periodic and not, the runners' accounting, a DispatchWindow
    chain of exchanges, and the drivers' ``--overlap 2`` runs."""
    import importlib

    from tpu_mpi_tests_torch.comm import collectives as C
    from tpu_mpi_tests_torch.comm import halo as H
    from tpu_mpi_tests_torch.comm import mesh as M
    from tpu_mpi_tests_torch.convert import grid_block

    def pipeline(fns, z, depth, grid_step=False):
        runner = H.OverlapRunner("halo_exchange", depth=depth)
        if grid_step:
            ex, cores = runner.step(fns[0], fns[1], z)
            return fns[2](ex, *cores), runner
        return H.overlap_steps(runner, fns, z, OV_ROUNDS), runner

    accounting = []
    for per in (False, True):
        z = _tensor(block_of(ov_jacobi_global(world, per), world, rank))
        fns = H.overlap_jacobi_fns(0, 2, OV_SCALE, OV_EPS, periodic=per)
        for depth in (1, 2):
            got, r = pipeline(fns, z.clone(), depth)
            _save(out_dir, f"ov_jacobi_p{int(per)}_d{depth}", rank, got)
            accounting.append([r.overlap_frac, r.comm_s, r.steps])
        _save(out_dir, f"ov_jacobi_p{int(per)}_serial", rank,
              H.iterate_fused_fn(0, 2, OV_SCALE, OV_EPS, periodic=per)(
                  z.clone(), OV_ROUNDS))
        for axis in (0, 1):
            zi = _tensor(block_of(ov_iterate_global(world, axis, per),
                                  world, rank, axis))
            for name, fn in (("overlap", H.iterate_overlap_fn),
                             ("hand", H.iterate_hand_fn)):
                _save(out_dir, f"ov_iterate_ax{axis}_p{int(per)}_{name}",
                      rank, fn(2, OV_EPS, axis=axis, periodic=per)(
                          zi.clone(), 5))
    _save(out_dir, "ov_accounting", rank, np.array(accounting))

    for px, py in GRIDS[world]:
        grid = M.make_grid(px, py)
        gn = grid_name(px, py)
        g = heat_global(px, py, 1)
        z = _tensor(grid_block(g, px, py, grid.rx, grid.ry))
        fns = H.heat_overlap_fns(HEAT_CX, HEAT_CY, grid)
        for depth in (1, 2):
            _save(out_dir, f"ov_heat_{gn}_d{depth}", rank,
                  pipeline(fns, z.clone(), depth)[0])
        _save(out_dir, f"ov_heat_{gn}_serial", rank,
              H.heat_step2d_fn(1, HEAT_CX, HEAT_CY, grid=grid)(
                  z.clone(), OV_ROUNDS))
        z = _tensor(grid_block(step_global(px, py), px, py, grid.rx,
                               grid.ry))
        fns = H.grid_overlap_fns(2, GRID_SX, GRID_SY, grid)
        outs = {depth: pipeline(fns, z.clone(), depth, grid_step=True)[0]
                for depth in (1, 2)}
        outs["serial"] = H.step2d_fn(2, GRID_SX, GRID_SY, grid=grid)(
            z.clone())
        for tag, (dx, dy, res) in outs.items():
            tag = tag if tag == "serial" else f"d{tag}"
            _save(out_dir, f"ov_grid_{gn}_{tag}_dx", rank, dx)
            _save(out_dir, f"ov_grid_{gn}_{tag}_dy", rank, dy)
            _save(out_dir, f"ov_grid_{gn}_{tag}_res", rank, res.reshape(1))
        for case, name, argv in OV_DRIVER_RUNS:
            module = importlib.import_module(
                f"tpu_mpi_tests_torch.drivers.{name}")
            _run_main(out_dir, f"ov_driver_{case}_{gn}", rank, module.main,
                      ["--device", "cpu", "--mesh", f"{px},{py}"] + argv)

    # a chain of periodic exchanges through a dispatch window of depth 2
    z = _tensor(block_of(ov_jacobi_global(world, True), world, rank))
    direct = z.clone()
    for _ in range(3):
        direct = H.halo_exchange(direct, 0, 2, True)
    with C.DispatchWindow(2) as win:
        windowed = z.clone()
        for _ in range(3):
            windowed = H.halo_exchange(windowed, 0, 2, True, window=win)
    _save(out_dir, "ov_window", rank,
          np.array([float(torch.equal(direct, windowed)),
                    float(torch.equal(direct, z))]))

    from tpu_mpi_tests_torch.drivers import stencil1d
    _run_main(out_dir, "ov_driver_stencil1d", rank, stencil1d.main,
              ["--device", "cpu"] + OV_STENCIL1D_ARGV)


#: the stencil2d driver's iterate leg, small, in float64 (the tune suite)
TUNE_DRIVER_ARGV = ["--n-local", "24", "--n-other", "16", "--iterate-steps",
                    "2", "--iterate-iters", "3", "--iterate-only",
                    "--dtype", "float64"]
#: the fleet sweep's stubbed per-candidate seconds on rank 0; every other
#: rank measures 10 − these, so its own argmin would be another candidate
TUNE_TIMINGS = {"blocks": 3.0, "rdma-chained": 1.0, "rdma-fused": 2.0,
                "xla": 4.0}


def tune_winner(text: str) -> str:
    """The tier a stencil2d run's iterate leg ran (its ``ITER tier=``)."""
    import re

    return re.search(r"^ITER tier=(\S+)", text, re.M).group(1)


def suite_tune(rank, world, out_dir):
    """The schedule plane over the ranks: ``fleet.bcast``, a fleet sweep
    whose stubbed measures differ by rank, the budget cut and the hit
    decision broadcast from rank 0, the one cache writer, ``stencil2d
    --iterate-tier auto --tune`` (then a cache-hit rerun and the explicit
    winner), and a broadcast rank 0 never answers."""
    import importlib

    from tpu_mpi_tests_torch.drivers import stencil2d
    from tpu_mpi_tests_torch.tune import fleet, registry

    sweep = importlib.import_module("tpu_mpi_tests_torch.tune.sweep")
    res = {"count": [fleet.process_count(), fleet.process_index()],
           "bcast": fleet.bcast({"from": rank, "v": [1, 2]}
                                if rank == 0 else None, "t:bcast")}

    own = os.path.join(out_dir, f"tc.r{rank}.json")
    registry.configure(cache_path=own, enabled=True)
    res["read_only"] = registry.configured_cache().read_only
    recs = []
    res["winner"] = sweep.sweep(
        "demo/fleet", lambda c: (TUNE_TIMINGS[c] if rank == 0
                                 else 10.0 - TUNE_TIMINGS[c]),
        candidates=tuple(TUNE_TIMINGS), emit=recs.append, dtype="float64")
    res["records"] = recs

    measured, recs = [], []

    def measure(c):
        measured.append(c)
        return 1.0

    res["budget_winner"] = sweep.sweep(
        "demo/budget", measure, candidates=("p", "x", "y"), budget_s=0.0,
        emit=recs.append)
    res["budget_measured"], res["budget_records"] = measured, recs
    # rank 0's cache holds demo/fleet; every other rank's is empty
    measured, recs = [], []
    res["hit"] = sweep.ensure_tuned(
        "demo/fleet", measure, candidates=tuple(TUNE_TIMINGS),
        emit=recs.append, dtype="float64")
    res["hit_measured"], res["hit_records"] = measured, recs
    registry.deconfigure()

    tc = os.path.join(out_dir, f"drv.r{rank}.json")
    argv = ["--device", "cpu", *TUNE_DRIVER_ARGV, "--tune-cache", tc]
    _run_main(out_dir, "tune_sweep", rank, stencil2d.main,
              argv + ["--iterate-tier", "auto", "--tune"])
    _run_main(out_dir, "tune_hit", rank, stencil2d.main,
              argv + ["--iterate-tier", "auto"])
    winner = fleet.bcast(tune_winner(read_text(out_dir, "tune_sweep", 0))
                         if rank == 0 else None, "t:winner")
    _run_main(out_dir, "tune_explicit", rank, stencil2d.main,
              argv + ["--iterate-tier", winner])

    # the knob owners outside the stencil path: collbench's variants,
    # the ring's depth and tier, the daxpy chunk — rank 0
    # sweeps, every rank runs the broadcast winner, rank 0 alone writes
    # its cache; each rank's JSONL its own .p<r> file with its clock_sync
    from tpu_mpi_tests_torch.drivers import attnbench, collbench
    from tpu_mpi_tests_torch.workloads import daxpy as wdaxpy

    kc = os.path.join(out_dir, f"knobs.r{rank}.json")
    common = ["--device", "cpu", "--tune", "--tune-cache", kc, "--jsonl",
              os.path.join(out_dir, "knobs.jsonl")]
    _run_main(out_dir, "knobs_coll", rank, collbench.main,
              common + ["--collectives", "auto", "--sizes-kib", "4",
                        "--n-iter", "10", "--telemetry"])
    _run_main(out_dir, "knobs_attn", rank, attnbench.main,
              common + ["--tiers", "ring", "--seq-len", "32",
                        "--head-dim", "16", "--n-iter", "10"])
    _run_main(out_dir, "knobs_daxpy", rank, wdaxpy.main,
              common + ["--n", "1024", "--iters", "8"])
    res["knobs_cache_written"] = os.path.exists(kc)

    # a broadcast rank 0 never answers (it posts under another tag) raises
    # on the others, naming their tag
    os.environ["TPU_MPI_FLEET_TIMEOUT_S"] = "1"
    tag = "answered" if rank == 0 else "lonely"
    try:
        res["timeout"] = fleet.bcast(rank, tag)
    except TimeoutError as e:
        res["timeout"] = str(e)
    finally:
        del os.environ["TPU_MPI_FLEET_TIMEOUT_S"]
    tdist.barrier()
    with open(os.path.join(out_dir, f"tune_results.r{rank}.txt"), "w") as f:
        json.dump(res, f)


#: the routing cases: (case, seed, tokens, d_model, capacity factor,
#: skew, combine, dtype); factors under 1 overflow, skew 0 is uniform
MOE_CASES = [
    ("a2a_f32", 0, 64, 8, 1.25, 0.5, "alltoall", "float32"),
    ("ag_f32_overflow", 1, 64, 8, 0.5, 1.0, "allgather", "float32"),
    ("a2a_f64_overflow", 2, 96, 4, 0.75, 2.0, "alltoall", "float64"),
    ("ag_bf16", 3, 64, 8, 1.0, 0.0, "allgather", "bfloat16"),
]
#: the embedding cases: (case, seed, vocab, d_model, batch, variant, dtype)
EMBED_CASES = [
    ("take_f32", 0, 64, 8, 24, "take", "float32"),
    ("onehot_f32", 1, 64, 8, 24, "onehot", "float32"),
    ("take_bf16", 2, 128, 4, 16, "take", "bfloat16"),
    ("onehot_f64", 3, 32, 4, 8, "onehot", "float64"),
]
#: scatter-adds a case chains (duplicates and repeats accumulate)
EMBED_ITERS = 3
#: the spec runs of the serving suite: (case, spec, argv)
SERVING_SPECS = [
    ("moe", "moe", ["--tokens", "128", "--d-model", "8", "--iters", "2",
                    "--capacity-factor", "1.0"]),
    ("moe_tune", "moe", ["--tokens", "128", "--d-model", "8", "--iters",
                         "2", "--dtype", "bfloat16", "--tune"]),
    ("embedding", "embedding", ["--vocab", "256", "--d-model", "8",
                                "--batch", "32", "--iters", "2"]),
    ("embedding_tune", "embedding", ["--vocab", "256", "--d-model", "8",
                                     "--batch", "32", "--iters", "2",
                                     "--tune"]),
    ("decode", "decode", ["--batches", "1,4", "--heads", "8", "--n-iter",
                          "20"]),
    ("decode_tune", "decode", ["--batches", "1,4", "--heads", "8",
                               "--n-iter", "20", "--dtype", "bfloat16",
                               "--tune"]),
]


def moe_inputs(case, world):
    """A routing case's host tokens and destinations, and its capacity
    (the spec's generator and capacity rule)."""
    from tpu_mpi_tests_torch.workloads import moe as spec

    _, seed, tokens, d_model, factor, skew, _, _ = case
    x, dest = spec._build_tokens(seed, tokens, d_model, skew, world)
    return x, dest, spec._capacity(tokens, world, factor)


def embed_inputs(case):
    """An embedding case's host table, ids and updates."""
    from tpu_mpi_tests_torch.workloads import embedding as spec

    _, seed, vocab, d_model, batch, _, _ = case
    return spec._build_table(seed, vocab, d_model, batch)


def suite_serving(rank, world, out_dir):
    """The serving-era paths over gloo: ``route_tokens`` on every
    ``MOE_CASES`` case (this rank's routed tokens and the demand
    matrix), the embedding lookup and ``EMBED_ITERS`` chained
    scatter-adds on every ``EMBED_CASES`` case, then the three specs
    (``SERVING_SPECS``) through the runner, each with its JSONL; last
    the serve driver (``SERVE_ARGV``), which serves at world 1 and on
    every rank of a larger world prints the JAX driver's single-process
    ERROR line and exits 2."""
    from tpu_mpi_tests_torch.comm import embedding as E
    from tpu_mpi_tests_torch.comm import moe as M
    from tpu_mpi_tests_torch.drivers import serve
    from tpu_mpi_tests_torch.workloads import runner

    for case in MOE_CASES:
        name, dtype, combine = case[0], getattr(torch, case[7]), case[6]
        x, dest, cap = moe_inputs(case, world)
        xs = _tensor(block_of(x, world, rank)).to(dtype)
        ds = _tensor(block_of(dest, world, rank))
        y, stats = M.route_tokens(xs, ds, cap, combine=combine)
        _save(out_dir, f"moe_{name}", rank, y)
        _save(out_dir, f"moe_{name}_counts", rank, stats.counts)
    for case in EMBED_CASES:
        name, variant, dtype = case[0], case[5], getattr(torch, case[6])
        table, ids, upd = embed_inputs(case)
        tab = _tensor(block_of(table, world, rank)).to(dtype)
        rows = E.embedding_lookup(tab, _tensor(ids), variant=variant)
        _save(out_dir, f"embed_{name}_lookup", rank, rows)
        for _ in range(EMBED_ITERS):
            tab = E.embedding_scatter_add(
                tab, _tensor(block_of(ids, world, rank)),
                _tensor(block_of(upd, world, rank)).to(dtype))
        _save(out_dir, f"embed_{name}_table", rank, tab)
    for case, name, argv in SERVING_SPECS:
        extra = ["--tune-cache", os.path.join(out_dir, f"{case}.json")] \
            if "--tune" in argv else []
        _run_main_both(out_dir, case, rank,
                       lambda a, name=name: runner.main([name] + a),
                       ["--device", "cpu", *argv, *extra, "--jsonl",
                        os.path.join(out_dir, f"{case}.jsonl")])
    _run_main(out_dir, "serve", rank, serve.main, SERVE_ARGV)


#: the serve driver's run in the serving suite: 0.2 s of one small class
SERVE_ARGV = ["--device", "cpu", "--duration", "0.2", "--rate", "40",
              "--workloads", "daxpy:64:float32"]


#: the topology suite's collective and exchange calls, each run under
#: telemetry on the world's own (one-host) layout and as two hosts
TOPO_HOSTS = 2


def _topo_spans(rank, world):
    """Run every stamped wrapper once with telemetry on; returns the span
    and route records (link fields and all)."""
    from tpu_mpi_tests_torch.comm import collectives as C
    from tpu_mpi_tests_torch.comm import embedding as E
    from tpu_mpi_tests_torch.comm import halo as H
    from tpu_mpi_tests_torch.comm import moe as M
    from tpu_mpi_tests_torch.comm import ring as R
    from tpu_mpi_tests_torch.comm.alltoall import ulysses_attention_fn
    from tpu_mpi_tests_torch.instrument import telemetry as T

    recs = []
    T.enable(sink=recs.append)
    try:
        z = torch.arange(12 * 4, dtype=torch.float64).reshape(12, 4)
        for per in (False, True):
            H.halo_exchange(z.clone(), axis=0, n_bnd=2, periodic=per)
        row = torch.ones((1, 8 * world), dtype=torch.float32)
        C.allreduce_sum(row.clone())
        C.reduce_scatter_sum(row.clone())
        C.all_gather(torch.ones(4))
        C.all_gather_inplace(torch.ones(4 * world))
        C.all_gather_rdma(torch.ones(4))
        C.all_gather_oneshot(torch.ones(4))
        C.allreduce_rdma(row.clone())
        C.allreduce_oneshot(row.clone())
        q = torch.ones((8, 4), dtype=torch.float64)
        R.ring_attention_fn(world)(q, q, q)
        qh = torch.ones((8, world, 4), dtype=torch.float64)
        ulysses_attention_fn(world)(qh, qh, qh)
        x, dest, cap = moe_inputs(MOE_CASES[0], world)
        M.route_tokens(_tensor(block_of(x, world, rank)).float(),
                       _tensor(block_of(dest, world, rank)), cap)
        table, ids, upd = embed_inputs(EMBED_CASES[0])
        tab = _tensor(block_of(table, world, rank)).float()
        E.embedding_lookup(tab, _tensor(ids))
        E.embedding_scatter_add(tab, _tensor(block_of(ids, world, rank)),
                                _tensor(block_of(upd, world, rank)).float())
    finally:
        T.disable()
    return [r for r in recs if r.get("kind") in ("span", "route")]


def suite_topo(rank, world, out_dir):
    """Link classes over gloo: every stamped wrapper's span records, the
    ``topo`` record and the meshes' stamps on the world's own layout
    (one host), then with this world as ``TOPO_HOSTS`` hosts (each rank's
    host name patched, the world's layout taken again from the host-name
    gather, as ``comm.dist.init`` takes it)."""
    import socket

    from tpu_mpi_tests_torch.comm import dist
    from tpu_mpi_tests_torch.comm import mesh as MS
    from tpu_mpi_tests_torch.comm import topology as TP
    from tpu_mpi_tests_torch.instrument import manifest

    def stamps():
        grid = MS.make_grid(2, world // 2)
        two = MS.make_mesh_2level()
        return {
            "topo": manifest.topo_record(),
            "manifest": {k: v for k, v in manifest.run_manifest(
                "cpu", argv=["x"]).items()
                if k in ("hosts", "ranks_per_host", "topology")},
            "world": TP.mesh_link_meta(),
            "grid_x": TP.mesh_link_meta(grid, "x"),
            "grid_y": TP.mesh_link_meta(grid, "y"),
            "grid_x_partners": TP.mesh_partner_links(grid, "x", (-1, 1),
                                                     False),
            "dcn": TP.mesh_link_meta(two, "dcn"),
            "ici": TP.mesh_link_meta(two, "ici"),
            "records": _topo_spans(rank, world),
        }

    out = {"one_host": stamps()}
    real_name, real_world = socket.gethostname, dist._WORLD
    socket.gethostname = lambda: f"host{rank * TOPO_HOSTS // world}"
    try:
        hosts, per, local = dist._host_layout(rank, world)
        dist._WORLD = dataclasses.replace(real_world, hosts=hosts,
                                          ranks_per_host=per,
                                          local_rank=local)
        out["two_hosts"] = stamps()
    finally:
        socket.gethostname, dist._WORLD = real_name, real_world
    with open(os.path.join(out_dir, f"topo.r{rank}.txt"), "w") as f:
        json.dump(out, f)


def suite_conform(rank, world, out_dir):
    """The drivers' span streams the ``--conform`` replay reads: stencil2d
    and collbench with ``--telemetry --jsonl`` (each rank writes its
    ``.p<rank>`` file next to the base path)."""
    from tpu_mpi_tests_torch.drivers import collbench, stencil2d

    _run_main(out_dir, "stencil2d", rank, stencil2d.main, [
        "--device", "cpu", "--n-local", "16", "--n-other", "32",
        "--n-iter", "3", "--telemetry",
        "--jsonl", os.path.join(out_dir, "stencil2d.jsonl")])
    _run_main(out_dir, "collbench", rank, collbench.main, [
        "--device", "cpu", "--sizes-kib", "1024", "--n-iter", "10",
        "--telemetry", "--jsonl", os.path.join(out_dir, "collbench.jsonl")])


SUITES = {"dist": suite_dist, "rdma": suite_rdma, "coll": suite_coll,
          "ring": suite_ring, "symm_one_card": suite_symm_one_card,
          "grid": suite_grid, "overlap": suite_overlap,
          "tune": suite_tune, "serving": suite_serving,
          "topo": suite_topo, "conform": suite_conform}
#: the device a suite's ranks join the world on (gloo either way)
SUITE_DEVICES = {"symm_one_card": "cuda"}

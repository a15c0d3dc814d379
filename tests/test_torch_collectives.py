"""The collective pillar of the port on the CPU: the ring all-gather, the
ring reduce-scatter / allreduce and the one-shot kernels' plain versions,
the collective tiers of ``comm/collectives.py``, and the ``collbench``,
``gather_inplace --rdma`` and ``stencil2d --rdma`` paths, on gloo worlds
of 2 and 4 ranks and at world=1, held against the JAX package on a 2-
and 4-device mesh.

On the CPU the wrappers (``hand.ring_allgather``,
``hand.ring_reduce_scatter``, ``hand.ring_allreduce``, ``hand.oneshot``)
take their plain versions, which move data over the gloo group
(``Ring.shift``, ``Ring.all_gather``); the kernels themselves run in
``tests/test_torch_gpu.py`` and ``chip_smoke.py``. One world per size is
spawned for the file (``tests/torch_dist_workers.py``, suite ``coll``).

Pairs and tolerances (all exact: the collectives copy, and the folds run
in the JAX kernels' order, so every sum is bitwise):

* the all-gather against ``lax.all_gather`` and the interpreted
  ``ring_allgather_pallas``: exact;
* the reduce-scatter and the allreduce, credits 1 and 2, against the
  interpreted ``ring_reduce_scatter_pallas`` / ``ring_allreduce_pallas``
  (``tests/test_pallas.py:452,471,833``): ``np.array_equal`` in float32
  and bfloat16 on random data, at the shapes the JAX kernels' tile
  floors admit; every case, the small ones too, against the plain
  versions' one-process world simulation (``hand.coll_world_ref``);
* the one-shot tiers against ``TestOneshotTier``'s pinned fold
  (``tests/test_collectives.py:101-166``), ``functools.reduce(add,
  shards)``, bitwise, the decode payloads (8- and 4-element rows)
  included, and against the JAX tiers;
* the ``self_ring=k`` plain versions at world=1 against the JAX
  package's interpreted self-ring (``tests/test_pallas.py:531,762``);
* ``reduce_scatter_sum`` against ``lax.psum_scatter`` and the hand
  ``allreduce_rdma`` tier against ``lax.psum``, on integer-valued rows.

The JAX package's six red race contracts in ``tests/test_ring_sync.py``
(the simulated multi-device interpreter's vector-clock checks of its
one-shot and fused kernels) stay red on this image; the port is held to
the bitwise tests above, which pass, not to them.
"""

import functools
import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import torch_dist_workers as W
from tpu_mpi_tests.comm import collectives as JC
from tpu_mpi_tests.comm.mesh import make_mesh
from tpu_mpi_tests.compat import shard_map
from tpu_mpi_tests.drivers import collbench as jcollbench
from tpu_mpi_tests.drivers import gather_inplace as jgather
from tpu_mpi_tests.kernels import pallas_kernels as PK
from tpu_mpi_tests_torch.comm import collectives as C
from tpu_mpi_tests_torch.comm.peer import COLL_MAX_WORLD, PeerError
from tpu_mpi_tests_torch.drivers import collbench, gather_inplace
from tpu_mpi_tests_torch.kernels import hand
from tpu_mpi_tests_torch.utils import TpuMtError
from tpu_mpi_tests_torch.tune import registry as treg

WORLDS = (2, 4)
CASES = [c[0] for c in W.COLL_CASES]
#: the cases whose shapes meet the JAX ring kernels' tile floors
JAX_CASES = [c for c in CASES if not c.startswith("small")]
DTYPES = {"float32": jnp.float32, "float64": jnp.float64,
          "bfloat16": jnp.bfloat16}
CPU = ["--device", "cpu"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return {w: W.spawn("coll", w, tmp_path_factory.mktemp(f"coll{w}"))
            for w in WORLDS}


@pytest.fixture(scope="module")
def meshes():
    return {w: make_mesh({"shard": w}, devices=jax.devices()[:w])
            for w in WORLDS}


def case_dtype(case):
    return dict((c[0], c[2]) for c in W.COLL_CASES)[case]


def global_of(case, w):
    g, _ = W.coll_shard(case, w, 0)
    return g


def per_rank(mesh, fn, g, dtype):
    """``fn(shard)`` on every device of ``mesh`` (each device's shard is
    ``g[rank]``), stacked along a new leading axis, as float32/float64."""
    run = jax.jit(functools.partial(
        shard_map, mesh=mesh, in_specs=P("shard"), out_specs=P("shard"),
        check_vma=False)(lambda x: fn(x[0])[None]))
    out = np.asarray(run(JC.shard_1d(jnp.asarray(g, DTYPES[dtype]), mesh)))
    return out.astype(np.float32) if dtype == "bfloat16" else out


def ranks(out_dir, case, w):
    return np.stack([W.load_rank(out_dir, case, r) for r in range(w)])


def torch_shards(case, w):
    dt = getattr(torch, case_dtype(case))
    return [torch.from_numpy(np.ascontiguousarray(b)).to(dt)
            for b in global_of(case, w)]


def as_np(t):
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


# ---------------------------------------------------------------------------
# the kernels' plain versions over gloo
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("w", WORLDS)
@pytest.mark.parametrize("case", CASES)
def test_ring_allgather_plain_matches_jax(runs, meshes, w, case):
    got = ranks(runs[w], f"ag_{case}", w)
    g = global_of(case, w)
    dt = case_dtype(case)
    want = per_rank(meshes[w], lambda x: jax.lax.all_gather(
        x, "shard", axis=0, tiled=True), g, dt)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.stack(
        [as_np(torch.cat(torch_shards(case, w)))] * w))
    if case in JAX_CASES:
        ring = per_rank(meshes[w], lambda x: PK.ring_allgather_pallas(
            x, axis_name="shard", interpret=True), g, dt)
        np.testing.assert_array_equal(got, ring)


@pytest.mark.parametrize("w", WORLDS)
@pytest.mark.parametrize("credits", [1, 2])
@pytest.mark.parametrize("case", CASES)
def test_ring_reduce_scatter_plain_matches_jax(runs, meshes, w, credits,
                                               case):
    got = ranks(runs[w], f"rs_{case}_c{credits}", w)
    want = [as_np(t) for t in hand.coll_world_ref("ring_reduce_scatter",
                                                  torch_shards(case, w))]
    assert np.array_equal(got, np.stack(want))
    if case in JAX_CASES:
        jax_rs = per_rank(meshes[w], lambda x: PK.ring_reduce_scatter_pallas(
            x, axis_name="shard", interpret=True, credits=credits),
            global_of(case, w), case_dtype(case))
        assert np.array_equal(got, jax_rs)


@pytest.mark.parametrize("w", WORLDS)
@pytest.mark.parametrize("credits", [1, 2])
@pytest.mark.parametrize("case", CASES)
def test_ring_allreduce_plain_matches_jax(runs, meshes, w, credits, case):
    got = ranks(runs[w], f"ar_{case}_c{credits}", w)
    rs = hand.coll_world_ref("ring_reduce_scatter", torch_shards(case, w))
    assert np.array_equal(got, np.stack([as_np(torch.cat(rs))] * w))
    if case in JAX_CASES:
        jax_ar = per_rank(meshes[w], lambda x: PK.ring_allreduce_pallas(
            x, axis_name="shard", interpret=True, credits=credits),
            global_of(case, w), case_dtype(case))
        assert np.array_equal(got, jax_ar)


@pytest.mark.parametrize("w", WORLDS)
@pytest.mark.parametrize("case", CASES)
def test_oneshot_plain_matches_pinned_fold(runs, w, case):
    shards = torch_shards(case, w)
    fold = functools.reduce(lambda a, b: a + b, shards)
    assert np.array_equal(ranks(runs[w], f"os_sum_{case}", w),
                          np.stack([as_np(fold)] * w))
    np.testing.assert_array_equal(ranks(runs[w], f"os_gather_{case}", w),
                                  np.stack([as_np(torch.cat(shards))] * w))
    if case_dtype(case) != "bfloat16":  # numpy's own fold where it can
        want = functools.reduce(np.add, list(global_of(case, w)))
        assert np.array_equal(as_np(fold), want)


@pytest.mark.parametrize("w", WORLDS)
@pytest.mark.parametrize("case", CASES[:3])
@pytest.mark.parametrize("name", ["ring_allgather", "ring_reduce_scatter",
                                  "oneshot_allgather", "oneshot_allreduce"])
def test_world_simulation_equals_the_gloo_ranks(runs, w, case, name):
    """``hand.coll_world_ref`` (all ranks in one process; what the card's
    cross-wired instances are held to) gives each rank what the plain
    version gives it over gloo."""
    short = {"ring_allgather": "ag", "ring_reduce_scatter": "rs",
             "oneshot_allgather": "os_gather",
             "oneshot_allreduce": "os_sum"}[name]
    gloo = f"{short}_{case}" + ("_c1" if short == "rs" else "")
    assert np.array_equal(ranks(runs[w], f"world_ref_{name}_{case}", w),
                          ranks(runs[w], gloo, w))


# ---------------------------------------------------------------------------
# the tiers on (1, L) rows
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("w", WORLDS)
@pytest.mark.parametrize("L", W.ONESHOT_ROWS)
def test_oneshot_tiers_match_the_pinned_fold_and_jax(runs, meshes, w, L):
    rows = W.global_field(300 + L, (w, L), np.float32)
    want = functools.reduce(np.add, [rows[r] for r in range(w)])
    got = ranks(runs[w], f"allreduce_oneshot_{L}", w)
    assert got.shape == (w, 1, L)
    for row in got:
        np.testing.assert_array_equal(row[0], want)
    jax_sum = np.asarray(JC.allreduce_oneshot(
        JC.shard_1d(jnp.asarray(rows), meshes[w]), meshes[w]))
    np.testing.assert_array_equal(got[:, 0], jax_sum)
    gathered = ranks(runs[w], f"all_gather_oneshot_{L}", w)
    for g in gathered:
        np.testing.assert_array_equal(g, rows.reshape(-1))


@pytest.mark.parametrize("w", WORLDS)
def test_library_and_ring_tiers_on_integer_rows(runs, meshes, w):
    ints = (np.arange(w * 8 * w, dtype=np.float32).reshape(w, 8 * w) % 13)
    rs = np.asarray(JC.reduce_scatter_sum(
        JC.shard_1d(jnp.asarray(ints), meshes[w]), meshes[w]))
    np.testing.assert_array_equal(
        ranks(runs[w], "reduce_scatter_sum", w)[:, 0], rs)
    psum = np.asarray(JC.allreduce_sum(
        JC.shard_1d(jnp.asarray(ints), meshes[w]), meshes[w]))
    for credits in (1, 2):
        np.testing.assert_array_equal(
            ranks(runs[w], f"allreduce_rdma_c{credits}", w)[:, 0], psum)
    for g in ranks(runs[w], "all_gather_rdma", w):
        np.testing.assert_array_equal(g, ints.reshape(-1))


@pytest.mark.parametrize("w", WORLDS)
def test_shape_errors_name_n_ranks_and_the_chunk_rule(runs, w):
    for r in range(w):
        lines = W.read_text(runs[w], "errors", r).splitlines()
        assert len(lines) == 5
        assert all(line.startswith("ValueError: ") for line in lines)
        for line in lines[:3]:
            assert f"(n_ranks={w}, L)" in line
        for line in lines[3:]:
            assert (f"a shard of {4 * w + 1} elements does not split into "
                    f"{w} equal chunks" in line)
            assert "elements % w == 0" in line


# ---------------------------------------------------------------------------
# world=1: the self-ring, the wrappers' checks
# ---------------------------------------------------------------------------


def one_device(fn, x):
    mesh = Mesh(np.array(jax.devices()[:1]), ("shard",))
    run = jax.jit(functools.partial(
        shard_map, mesh=mesh, in_specs=P(), out_specs=P(),
        check_vma=False)(fn))
    return np.asarray(run(x))


@pytest.mark.parametrize("k", [2, 4, 8])
@pytest.mark.parametrize("credits", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_self_ring_reduce_scatter_matches_jax(k, credits, dtype):
    g = W.global_field(400 + k, (k * 16, 8), np.float32)
    x = torch.from_numpy(g).to(getattr(torch, dtype))
    got = as_np(hand.ring_reduce_scatter(x, credits=credits, self_ring=k))
    want = one_device(lambda v: PK.ring_reduce_scatter_pallas(
        v, axis_name="shard", interpret=True, self_ring=k, credits=credits),
        jnp.asarray(g, DTYPES[dtype])).astype(np.float32)
    assert np.array_equal(got, want)
    # the fold of the shard's own k chunks in the ring's order
    chunks = x.view(k, 16, 8)
    acc = chunks[k - 1]
    for c in range(k - 2, -1, -1):
        acc = acc + chunks[c]
    assert np.array_equal(got, as_np(acc))


@pytest.mark.parametrize("k", [2, 4, 8])
def test_self_ring_allgather_matches_jax(k):
    g = W.global_field(410 + k, (16, 8), np.float32)
    got = hand.ring_allgather(torch.from_numpy(g), self_ring=k).numpy()
    want = one_device(lambda v: PK.ring_allgather_pallas(
        v, axis_name="shard", interpret=True, self_ring=k), jnp.asarray(g))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.tile(g, (k, 1)))


def test_world1_collectives_are_copies_and_the_checks_raise():
    x = torch.from_numpy(W.global_field(420, (12, 3)))
    for fn in (hand.ring_allgather, hand.ring_reduce_scatter,
               hand.ring_allreduce, hand.oneshot_allgather,
               hand.oneshot_allreduce):
        out = fn(x)
        assert torch.equal(out, x) and out.data_ptr() != x.data_ptr()
    # the port's rule is the algorithm's: any n at world=1, n % k on a
    # k-ring; the JAX kernels' tile floor (rows % 8) is not kept
    assert torch.equal(hand.ring_reduce_scatter(x, self_ring=3),
                       (x[8:] + x[4:8]) + x[:4])
    with pytest.raises(ValueError, match="rows % w == 0"):
        hand.ring_reduce_scatter(x, self_ring=5)
    with pytest.raises(PeerError, match=f"at most {COLL_MAX_WORLD}"):
        hand.ring_allgather(x, self_ring=COLL_MAX_WORLD + 1)
    with pytest.raises(ValueError, match="single-device validation"):
        hand.ring_allgather(x, self_ring=1)
    with pytest.raises(ValueError, match="credits=3"):
        hand.ring_reduce_scatter(x, credits=3)
    with pytest.raises(ValueError, match="op must be"):
        hand.oneshot(x, "max")
    with pytest.raises(ValueError, match="1-D or 2-D"):
        hand.ring_allgather(x[None])
    with pytest.raises(ValueError, match=r"\(n_ranks=1, L\)"):
        C.allreduce_rdma(torch.ones(2, 8))
    with pytest.raises(ValueError, match=r"\(n_ranks=1, L\)"):
        C.allreduce_oneshot(torch.ones(8))
    with pytest.raises(ValueError, match="unsupported device"):
        hand.oneshot(x.to("meta"))


# ---------------------------------------------------------------------------
# the drivers
# ---------------------------------------------------------------------------


def coll_rows(text):
    return re.findall(collbench.COLL_LINE_RE, text)


def test_coll_line_format_and_busbw_are_the_jax_drivers():
    assert collbench.COLL_LINE_RE == jcollbench.COLL_LINE_RE
    names = (jcollbench.COLLECTIVES + jcollbench.COLLECTIVES_RDMA
             + jcollbench.COLLECTIVES_ONESHOT)
    assert names == (collbench.COLLECTIVES + collbench.COLLECTIVES_RDMA
                     + collbench.COLLECTIVES_ONESHOT)
    for name in names:
        for world in (1, 2, 3, 4, 8):
            for nbytes in (4096, 1 << 20):
                assert collbench._busbw_bytes(name, nbytes, world) == \
                    jcollbench._busbw_bytes(name, nbytes, world)


def test_collbench_world1_rows_and_refusals(capsys, tmp_path):
    names = ",".join(collbench.COLLECTIVES + collbench.COLLECTIVES_RDMA
                     + collbench.COLLECTIVES_ONESHOT)
    jsonl = tmp_path / "c.jsonl"
    assert collbench.main(CPU + ["--collectives", names, "--sizes-kib",
                                 "64,1024", "--n-iter", "10", "--jsonl",
                                 str(jsonl)]) == 0
    rows = coll_rows(capsys.readouterr().out)
    assert [r[0] for r in rows] == [n for n in names.split(",")
                                    for _ in range(2)]
    assert all(float(r[3]) == 0.0 for r in rows)  # world=1: nothing moves
    recs = [json.loads(line) for line in jsonl.read_text().splitlines()]
    assert [r["kind"] for r in recs[:3]] == ["manifest", "topo",
                                             "clock_sync"]
    recs = [r for r in recs if r["kind"] == "coll"]
    assert all(set(r) == {"kind", "collective", "dtype", "shard_bytes",
                          "us_per_iter", "busbw_gbps", "world", "n_iter"}
               | ({"rdma_credits"} if r["collective"] == "allreduce_rdma"
                  else set()) for r in recs)
    assert collbench.main(CPU + ["--collectives", "allgather,bogus"]) == 2
    assert "ERROR unknown collective" in capsys.readouterr().out
    # --collectives auto: the collectives with hand twins, each size's
    # variant resolved (the prior, the library tier, with no cache), the
    # rows marked auto; --tune sweeps the variants
    jl2 = tmp_path / "auto.jsonl"
    cache = str(tmp_path / "tune.json")
    try:
        assert collbench.main(CPU + ["--collectives", "auto", "--sizes-kib",
                                     "4", "--jsonl", str(jl2)]) == 0
        assert [r[0] for r in coll_rows(capsys.readouterr().out)] == [
            "allgather", "allreduce"]
        assert all(r.get("auto") for r in map(json.loads,
                   jl2.read_text().splitlines()) if r["kind"] == "coll")
        assert collbench.main(CPU + ["--collectives", "auto", "--tune",
                                     "--tune-cache", cache, "--sizes-kib",
                                     "4", "--telemetry"]) == 0
        out = capsys.readouterr().out
        for knob in ("coll_variant/allgather", "coll_variant/allreduce"):
            assert f"TUNE {knob} winner=" in out, out
        assert "coll/dispatch_depth" not in out  # no reader, no sweep
        assert "TELEMETRY allreduce :" in out
    finally:
        treg.deconfigure()
    with pytest.raises(TpuMtError, match="queue 1 item 19"):
        collbench.serve_step_factory(None, (64,), "float32")
    # the ring's chunking (a COLL-SKIP row, stencil2d's NOTE) refuses
    # nothing at world=1; at world w a row of L % w != 0 elements
    assert C.allreduce_rdma_refusal(1001) is None


@pytest.mark.parametrize("w", WORLDS)
def test_collbench_rows_at_world(runs, w):
    names = (collbench.COLLECTIVES + collbench.COLLECTIVES_RDMA
             + collbench.COLLECTIVES_ONESHOT)
    for r in range(w):
        out = W.read_text(runs[w], "collbench", r)
        assert out.startswith("RC 0\n"), out
        rows = coll_rows(out)
        assert [row[0] for row in rows] == [n for n in names
                                            for _ in range(2)]
        # a row whose time and busbw both print nan is a chain whose two
        # lengths did not difference to a positive time (chain_rate: host
        # noise over a gloo chain), counted, as chip_smoke.py's collbench
        # check counts it; the row's structure holds all the same, and
        # every other row is a positive time and busbw
        timed = 0
        for name, nbytes, us, busbw, n_iter, credits in rows:
            if us != "nan" or busbw != "nan":
                assert float(us) > 0 and float(busbw) > 0
                timed += 1
            assert int(n_iter) == (160 if nbytes == "65536" else 10)
            assert credits == ("1" if name == "allreduce_rdma" else "")
        assert timed > 0
        c2 = coll_rows(W.read_text(runs[w], "collbench_c2", r))
        assert [(row[0], row[5]) for row in c2] == [("allreduce_rdma", "2")]
    recs = [json.loads(line) for line in
            open(f"{runs[w]}/collbench.p0.jsonl").read().splitlines()]
    assert [rec["kind"] for rec in recs[:3]] == ["manifest", "topo",
                                                 "clock_sync"]
    recs = [rec for rec in recs if rec["kind"] == "coll"]
    assert {rec["world"] for rec in recs} == {w}
    assert len(recs) == 2 * len(names)


def jax_gather_lines(monkeypatch, capsys, w, rdma):
    """The JAX driver's rank lines on a ``w``-device world."""
    real = jax.devices
    monkeypatch.setattr(jax, "devices", lambda *a, **k: real(*a, **k)[:w])
    assert jgather.main(["--n-per-rank", "1024", "--dtype", "float64"]
                        + (["--rdma"] if rdma else [])) == 0
    monkeypatch.setattr(jax, "devices", real)
    return [line for line in capsys.readouterr().out.splitlines()
            if re.match(r"\d+/\d+ lsum=", line)]


@pytest.mark.parametrize("rdma", [False, True])
def test_gather_inplace_world1_lines_equal_jax(monkeypatch, capsys, rdma):
    want = jax_gather_lines(monkeypatch, capsys, 1, rdma)
    before = hand.ring_allgather.launches
    assert gather_inplace.main(CPU + ["--n-per-rank", "1024", "--dtype",
                                      "float64"]
                               + (["--rdma"] if rdma else [])) == 0
    out = capsys.readouterr().out
    assert out.splitlines() == want == ["0/1 lsum=1024.0 asum=1024.0"]
    # on the CPU the wrapper takes its plain version: no launch
    assert hand.ring_allgather.launches == before


@pytest.mark.parametrize("w", WORLDS)
@pytest.mark.parametrize("rdma", [False, True])
def test_gather_inplace_at_world(runs, monkeypatch, capsys, w, rdma):
    want = jax_gather_lines(monkeypatch, capsys, w, rdma)
    assert len(want) == w
    for r in range(w):
        out = W.read_text(runs[w], f"gather_inplace_rdma{int(rdma)}", r)
        assert out.startswith("RC 0\n"), out
        assert out.splitlines()[1:] == want
        assert "PARITY FAIL" not in out


@pytest.mark.parametrize("w", WORLDS)
def test_stencil2d_rdma_allreduce_leg_goes_through_the_ring(runs, w):
    """Under --rdma the allreduce leg runs allreduce_rdma: 2 dims × (1
    warm + 2 timed) calls on every rank, and its gate passes."""
    for r in range(w):
        out = W.read_text(runs[w], "stencil2d_rdma", r)
        assert out.startswith("RC 0\n"), out
        assert out.count("allreduce=") == 2
        assert "FAIL" not in out and "NOTE" not in out
        assert W.read_text(runs[w], "stencil2d_rdma_calls", r) == "6"


@pytest.mark.parametrize("w", WORLDS)
def test_stencil2d_rdma_row_the_ring_refuses_takes_the_library_tier(runs,
                                                                    w):
    """A row of 4w + 1 elements does not split into w chunks: each dim's
    allreduce leg prints the JAX driver's NOTE and runs allreduce_sum."""
    for r in range(w):
        out = W.read_text(runs[w], "stencil2d_rdma_note", r)
        assert out.startswith("RC 0\n"), out
        for dim in (0, 1):
            assert (f"NOTE dim:{dim} device: rdma allreduce below alignment "
                    f"floor, using allreduce_sum (ring_reduce_scatter: a "
                    f"shard of {4 * w + 1} elements does not split into {w} "
                    f"equal chunks") in out
        assert out.count("allreduce=") == 2 and "FAIL" not in out

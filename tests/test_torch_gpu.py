"""The hand CUDA kernels on the card (marker ``cuda``; skipped without a
GPU). Run them on a machine with one:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py

(``--noconftest``: the suite's conftest imports jax, which the port's
machine need not have; this file imports only torch and the port.)

Each kernel is held against its plain version on the same CUDA tensors,
bit for bit (the kernels round where the eager torch ops round) — the
dual step's residual, a sum in another order, within
``hand.RESIDUAL_RTOL`` — and a wrapper given a CUDA tensor returns a
CUDA tensor and counts a launch. The 2-D grid drivers run end to end on
the card with ``--kernel hand`` at a small size. The streaming kernels
(daxpy, scale, sum3) are held against their plain versions bit for bit,
out of place and in place, on ragged and misaligned operands, on both
routes (``vec16`` on operands that start on 16 bytes, ``scalar`` on a
view one element past them) at the edges of a vec16 group (one pack, a
group ± 1 pack, two groups ± 1 element), each launch
counted on its route, and a launch given another route than the
rule's refused; the DAXPY
drivers and the microbench groups run on the card at small sizes. The
flash-attention fold is held against its plain version within stated
tolerances (sums in another order; tensor-core operands rounded at
DEFAULT), dense and causal with masked, live and strided offsets, and in
the (L, H, d) layout in one launch; its wgmma route (bf16 DEFAULT) on
ragged shapes, causal offsets and both (L, H, d) stride orders, every
geometry class counted on its route, and a launch given another route
than the rule's refused. The fused ring attention is held
bit for bit against the pipelined tier's flash launches and within the
flash tolerances against its plain version, at world=1, on the self-ring
(k = 2, 4, 8) and as w = 2 and 4 instances cross-wired on one card,
chained on the 128-word pad. The ring all-gather and reduce-scatter
are held bit for bit on both routes (``vec16`` on shards of whole
16-byte vectors, ``scalar`` on 1001-row shards and misaligned views) at
world=1, on the self-ring (k = 2, 4, 8, credits 1 and 2) and cross-wired
(w = 2 and 4), each launch counted on its route, in a chain across
kernels, credits and routes on one pad, and a launch given another
route than the rule's refused. The ring halo and the one-shot kernel are
held bit for bit on both routes (``vec16`` where the rule admits 16-byte
vectors, ``scalar`` on other widths, staged extents and views off 16
bytes), each launch counted on its route, at world=1, on the self-ring
and as cross-wired instances (the ring halo at w = 2 and 4, the one-shot
kernel at w = 2, 4 and 8), at the main paths' operands, chained on one
pad with the fused RDMA kernel, and refusing another route. The k-step
kernels on both routes (``regs`` up to 8 steps on rows that start on 8
bytes for the iterate, in 16- or 8-byte vectors, and on 16 bytes for the
fused kernel; ``smem`` at 9 and 12 steps and off them), every launch
counted on its route, bit for bit: the iterate in three dtypes, both
dims, every flag pair; the fused kernel against the chained tier over 21
calls, against its plain version, and as w = 2 and 4 cross-wired
instances with its sends on vec16, scalar and staged; a launch given
another route than the rule's refused. The ALU
probe is held bit for bit (``fma``, ``step5*``, ``heat5``) or within
``hand.alu_probe_tolerance`` (the dual mixes), with its chain property
and capacity guard; pack and unpack bit for bit on both axes and on
every route (``vec16``, ``vec8``, ``scalar``: 2-, 4- and 8-byte
elements, n_bnd 1, 2, 3, 8, odd widths, one and two rows, views off 16
bytes), each launch counted on its route, a launch given another route
refused, and the hand-staged exchange against DIRECT on each route;
the dual step's lean body like the raw one; the ``vpu`` group and the
``stencil1d`` driver run on the card at small sizes.
"""

import importlib.util
from pathlib import Path

import pytest
import torch

import torch_dist_workers as W
from tpu_mpi_tests_torch import microbench
from tpu_mpi_tests_torch.comm import halo as TH
from tpu_mpi_tests_torch.drivers import (
    daxpy,
    envprobe,
    gather_inplace,
    heat2d,
    mpi_daxpy,
    mpi_daxpy_nvtx,
    stencil1d,
    stencil2d_grid,
)
from tpu_mpi_tests_torch.kernels import hand

pytestmark = pytest.mark.cuda

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
CS = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(CS)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU "
                    "mode (their plain versions are tested on the CPU)")
    return torch.device("cuda", 0)


def rand(card, shape, dtype, seed):
    g = torch.Generator(device=card).manual_seed(seed)
    return torch.randn(shape, generator=g, device=card).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
@pytest.mark.parametrize("dim", [0, 1])
@pytest.mark.parametrize("flags", [(0, 0), (1, 1), (1, 0), "dynamic"])
def test_iterate_kernel_matches_plain(card, dtype, dim, flags):
    steps = 3
    shape = (2 * 2 * steps + 141, 77) if dim == 0 else (19, 300)
    z = rand(card, shape, dtype, seed=dim)
    kw = ({"phys": torch.tensor([1, 0], dtype=torch.int32, device=card)}
          if flags == "dynamic" else {"phys_static": flags})
    before = hand.stencil2d_iterate.launches
    got = hand.stencil2d_iterate(z, 0.37, dim=dim, steps=steps, **kw)
    want = hand.stencil2d_iterate_ref(z, 0.37, dim=dim, steps=steps, **kw)
    torch.cuda.synchronize(card)
    assert got.device == card
    assert hand.stencil2d_iterate.launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
@pytest.mark.parametrize("dim", [0, 1])
def test_deriv_kernel_matches_plain(card, dtype, dim):
    z = rand(card, (133, 301) if dim == 0 else (301, 133), dtype, seed=7)
    before = hand.stencil2d_deriv.launches
    got = hand.stencil2d_deriv(z, 3.0, dim=dim)
    want = hand.stencil2d_deriv_ref(z, 3.0, dim=dim)
    torch.cuda.synchronize(card)
    assert got.device == card
    assert hand.stencil2d_deriv.launches == before + 1
    assert torch.equal(got, want)


def offset_view(card, shape, dtype, off_bytes, seed):
    """A contiguous ``shape`` view of random values ``off_bytes`` past a
    16-byte boundary (``chip_smoke.offset_view``)."""
    return CS.offset_view(lambda s, d: rand(card, s, d, seed), shape, dtype,
                          off_bytes)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
@pytest.mark.parametrize("dim", [0, 1])
@pytest.mark.parametrize("geometry", ["rows16", "rows8", "view"])
@pytest.mark.parametrize("rows", [9, 131, 1000])
def test_deriv_both_routes_match_plain(card, dtype, dim, geometry, rows):
    """Both routes bit for bit, each launch counted on the route the rule
    names: regs in 16-byte vectors where every row of z and out starts on
    16 bytes, in 8-byte ones where on 8, scalar on a view 4 bytes off
    (bfloat16 and float32) — ragged against the runs and the dim-1
    segment."""
    item = torch.empty((), dtype=dtype).element_size()
    # rows of z and out on 16 bytes, on 8 (not 16), and off 8 (the 16-byte
    # width, a view 4 bytes off)
    width = CS.GEOMETRY_WIDTH["rows16" if geometry == "view"
                              else geometry](item)
    shape = (rows + 4, width) if dim == 0 else (rows, width + 4)
    if geometry == "view" and item == 8:
        pytest.skip("a float64 view is always on 8 bytes")
    z = offset_view(card, shape, dtype, 4 if geometry == "view" else 0,
                    seed=rows + dim)
    route = hand.deriv_route(z, dim)
    vec = hand.deriv_vec_bytes(z, dim)
    assert vec == {"rows16": 16, "rows8": 8, "view": 0}[geometry] or (
        dim == 1 and geometry == "rows16" and vec == 8)
    assert route == ("regs" if vec else "scalar")
    before = dict(hand.stencil2d_deriv.launches_by_route)
    got = hand.stencil2d_deriv(z, 3.0, dim=dim)
    want = hand.stencil2d_deriv_ref(z, 3.0, dim=dim)
    torch.cuda.synchronize(card)
    assert torch.equal(got, want)
    after = hand.stencil2d_deriv.launches_by_route
    assert {r: after[r] - before[r] for r in after} == {
        r: int(r == route) for r in hand.DERIV_ROUTES}


def test_deriv_launch_refuses_another_route(card, monkeypatch):
    """The launcher checks the route it is given: a wrapper that named
    another route than the rule's gets an error, never a fallback."""
    z = rand(card, (64, 128), torch.float32, seed=3)
    odd = rand(card, (64, 129), torch.float32, seed=4)
    monkeypatch.setattr(hand, "deriv_route", lambda *a, **k: "scalar")
    with pytest.raises(RuntimeError, match="scalar route"):
        hand.stencil2d_deriv(z, 1.0, dim=0)
    monkeypatch.setattr(hand, "deriv_route", lambda *a, **k: "regs")
    with pytest.raises(RuntimeError, match="regs route"):
        hand.stencil2d_deriv(odd, 1.0, dim=1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
@pytest.mark.parametrize("steps", [*range(1, 10)])
@pytest.mark.parametrize("geometry", ["rows16", "rows8", "rows4", "rows2"])
@pytest.mark.parametrize("rows", [3, 150])
def test_heat2d_both_routes_match_plain(card, dtype, steps, geometry, rows):
    """Both routes bit for bit, each launch counted on the route the rule
    names: regs up to 8 steps on rows that start on 16, 8 or 4 bytes (the
    widest vector that holds a word), smem at 9 steps and on bfloat16
    rows off 4 bytes; 3 rows (no interior row but one) and 150 (ragged
    against the runs), a width ragged against the warp segment."""
    item = torch.empty((), dtype=dtype).element_size()
    # rows on 16, 8 and 4 bytes, and bfloat16 rows off 4 bytes (smem)
    width = CS.GEOMETRY_WIDTH[geometry](item)
    if (geometry == "rows4" and item == 8) or (geometry == "rows2"
                                               and item != 2):
        pytest.skip("no such row for this dtype")
    z = rand(card, (rows, width), dtype, seed=steps + rows)
    vec = hand.heat_vec_bytes(z)
    assert vec == {"rows16": 16, "rows8": 8, "rows4": 4, "rows2": 0}[
        geometry]
    route = hand.heat_route(z, steps)
    assert route == ("regs" if steps <= 8 and vec else "smem")
    before = dict(hand.heat2d.launches_by_route)
    got = hand.heat2d(z, 0.13, 0.21, steps=steps)
    want = hand.heat2d_ref(z, 0.13, 0.21, steps=steps)
    torch.cuda.synchronize(card)
    assert torch.equal(got, want)
    after = hand.heat2d.launches_by_route
    assert {r: after[r] - before[r] for r in after} == {
        r: int(r == route) for r in hand.HEAT_ROUTES}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("steps", [1, 4, 8])
@pytest.mark.parametrize("shape", [(3, 3), (5, 7), (40, 20), (70, 1000)])
def test_heat2d_regs_edges_match_plain(card, dtype, steps, shape):
    """The regs route on shards narrower than one warp segment, 3×3, and
    on a view 4 bytes off 16 (4-byte vectors), bit for bit."""
    for z in (rand(card, shape, dtype, seed=steps),
              offset_view(card, shape, dtype, 4, seed=steps)):
        got = hand.heat2d(z, 0.1, 0.2, steps=steps)
        want = hand.heat2d_ref(z, 0.1, 0.2, steps=steps)
        torch.cuda.synchronize(card)
        assert hand.heat_route(z, steps) == ("regs" if hand.heat_vec_bytes(z)
                                             else "smem")
        assert torch.equal(got, want)


def test_heat2d_launch_refuses_another_route(card, monkeypatch):
    """The launcher checks the route it is given: a wrapper that named
    another route than the rule's gets an error, never a fallback."""
    z = rand(card, (64, 128), torch.float32, seed=3)
    odd = rand(card, (64, 129), torch.bfloat16, seed=4)
    monkeypatch.setattr(hand, "heat_route", lambda *a, **k: "smem")
    with pytest.raises(RuntimeError, match="smem route"):
        hand.heat2d(z, 0.1, 0.1, steps=2)
    monkeypatch.setattr(hand, "heat_route", lambda *a, **k: "regs")
    with pytest.raises(RuntimeError, match="regs route"):
        hand.heat2d(odd, 0.1, 0.1, steps=2)
    with pytest.raises(RuntimeError, match="regs route"):
        hand.heat2d(z, 0.1, 0.1, steps=9)


@pytest.mark.parametrize("periodic", [False, True])
def test_blocks_runner_on_card_matches_cpu(card, periodic):
    """The S=2 runner on the card equals the runner on the CPU (the plain
    versions there), launch for launch."""
    K, S = 8, 2
    z = rand(card, (2 * 40 + 2 * K, 96), torch.float32, seed=3)
    run = TH.iterate_hand_blocks_fn(S, K, 0.05, steps=4, periodic=periodic)
    got = TH.merge_blocks(run(TH.split_blocks(z, S, K), 3), K)
    want = TH.merge_blocks(run(TH.split_blocks(z.cpu(), S, K), 3), K)
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
@pytest.mark.parametrize("steps", [1, 2, 4])
@pytest.mark.parametrize("shape", [(68, 52), (200, 300)])
def test_heat2d_kernel_matches_plain(card, dtype, steps, shape):
    z = rand(card, shape, dtype, seed=steps)
    before = hand.heat2d.launches
    got = hand.heat2d(z, 0.1, 0.2, steps=steps)
    want = hand.heat2d_ref(z, 0.1, 0.2, steps=steps)
    torch.cuda.synchronize(card)
    assert got.device == card
    assert hand.heat2d.launches == before + 1
    assert torch.equal(got, want)


def test_heat2d_rejects_aliasing_and_too_deep_steps(card):
    """Aliasing is refused; so is a depth beyond shared memory, which only
    the smem route has (a depth the regs route takes is never refused
    for it)."""
    z = rand(card, (40, 40), torch.float32, seed=1)
    with pytest.raises(ValueError, match="share storage"):
        hand.heat2d(z, 0.1, 0.1, out=z)
    deepest = hand.heat2d_max_steps(torch.float32)
    assert deepest > hand.HEAT_REGS_MAX_STEPS
    with pytest.raises(ValueError, match="shared memory"):
        hand.heat2d(z, 0.1, 0.1, steps=deepest + 1)
    odd = rand(card, (40, 41), torch.bfloat16, seed=2)
    deepest = hand.heat2d_max_steps(torch.bfloat16)
    with pytest.raises(ValueError, match="shared memory"):
        hand.heat2d(odd, 0.1, 0.1, steps=deepest + 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
@pytest.mark.parametrize("shape", [(68, 52), (301, 133)])
def test_dual_dim_step_kernel_matches_plain(card, dtype, shape):
    z = rand(card, shape, dtype, seed=5)
    before = hand.dual_dim_step.launches
    gx, gy, gr = hand.dual_dim_step(z, 2, 1.5, 0.75)
    wx, wy, wr = hand.dual_dim_step_ref(z, 2, 1.5, 0.75)
    torch.cuda.synchronize(card)
    assert hand.dual_dim_step.launches == before + 1
    assert torch.equal(gx, wx) and torch.equal(gy, wy)
    assert gr.dtype == dtype and gr.device == card
    assert abs(float(gr) - float(wr)) <= hand.RESIDUAL_RTOL[dtype] * abs(
        float(wr))


@pytest.mark.parametrize("halo_steps", [1, 4])
def test_heat_step2d_hand_runner_on_card_matches_cpu(card, halo_steps):
    z = rand(card, (64 + 2 * halo_steps, 48 + 2 * halo_steps),
             torch.float32, seed=9)
    run = TH.heat_step2d_fn(halo_steps, 0.1, 0.2, steps=halo_steps,
                            kernel="hand")
    got = run(z.clone(), 3)
    want = run(z.cpu(), 3)
    assert torch.equal(got.cpu(), want)


def test_grid_drivers_hand_on_card(card, capsys):
    assert heat2d.main(["--mesh", "1,1", "--nx-local", "96", "--ny-local",
                        "80", "--n-steps", "24", "--halo-steps", "4",
                        "--kernel", "hand"]) == 0
    assert stencil2d_grid.main(["--mesh", "1,1", "--nx-local", "96",
                                "--ny-local", "80", "--n-iter", "3",
                                "--n-warmup", "1", "--kernel", "hand"]) == 0
    out = capsys.readouterr().out
    assert "HEAT ERR rel=" in out and "GRID TEST px:1 py:1" in out
    assert "FAIL" not in out


def stream_case(name, ops, a, inplace):
    """(kernel result, plain result) of one streaming kernel; in place,
    the kernel writes into a copy of its last operand at the same offset
    from 16 bytes."""
    kernel, plain = getattr(hand, name), getattr(hand, f"{name}_ref")
    args = ops if name == "stream_sum3" else (a, *ops)
    want = plain(*args)
    if inplace:
        tgt = CS.same_offset_copy(args[-1])
        got = kernel(*args[:-1], tgt, out=tgt)
        assert got.data_ptr() == tgt.data_ptr()
    else:
        got = kernel(*args)
    return got, want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
@pytest.mark.parametrize("n,offset", [(1, 0), (127, 0), (4099, 0),
                                      (4099, 1)])
@pytest.mark.parametrize("inplace", [False, True])
def test_stream_kernels_match_plain(card, dtype, n, offset, inplace):
    w, x, y = (rand(card, (n + offset,), dtype, seed=s)[offset:]
               for s in (1, 2, 3))
    for name, ops in (("daxpy", (x, y)), ("stream_scale", (x,)),
                      ("stream_sum3", (w, x, y))):
        for a in (2.0, 1e-7, 1.0 + 1e-9):
            before = getattr(hand, name).launches
            got, want = stream_case(name, ops, a, inplace)
            torch.cuda.synchronize(card)
            assert getattr(hand, name).launches == before + 1
            assert got.device == card
            assert torch.equal(got, want), (name, a)


def stream_routes():
    return {name: dict(getattr(hand, name).launches_by_route)
            for name in CS.STREAM_KERNELS}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
@pytest.mark.parametrize("edge", range(5))
@pytest.mark.parametrize("route", ["vec16", "scalar"])
@pytest.mark.parametrize("inplace", [False, True])
def test_stream_routes_at_group_edges(card, dtype, edge, route, inplace):
    """Each route, each dtype, in and out of place, at n on the edges of
    a vec16 group (``chip_smoke.stream_edges``: one pack, one group ± 1
    pack, the grid's CTAs × the group ± 1 element); operands on 16 bytes
    take vec16, a view one element past them scalar. Bit for bit against
    the plain version, each launch counted on its route."""
    n = CS.stream_edges(dtype)[edge]
    for i, name in enumerate(CS.STREAM_KERNELS):
        off = int(route == "scalar")
        w, x, y = (rand(card, (n + off,), dtype, seed=10 * i + s)[off:]
                   for s in (1, 2, 3))
        ops = {"daxpy": (x, y), "stream_scale": (x,),
               "stream_sum3": (w, x, y)}[name]
        assert hand.stream_route(*ops) == route
        before = stream_routes()[name]
        got, want = stream_case(name, ops, 1.0 + 1e-9, inplace)
        torch.cuda.synchronize(card)
        assert torch.equal(got, want), (name, n)
        after = stream_routes()[name]
        assert {r: after[r] - before[r] for r in after} == \
            {r: int(r == route) for r in after}, (name, n)


def test_stream_launch_refuses_another_route(card, monkeypatch):
    """The launcher checks the route it is given: a wrapper that named
    another route than the rule's gets an error, never a fallback."""
    x = rand(card, (1000,), torch.float32, seed=5)
    y = rand(card, (1000,), torch.float32, seed=6)
    monkeypatch.setattr(hand, "stream_route", lambda *a: "scalar")
    with pytest.raises(RuntimeError, match="scalar route"):
        hand.daxpy(2.0, x, y)
    with pytest.raises(RuntimeError, match="scalar route"):
        hand.stream_scale(2.0, x, out=x)
    monkeypatch.setattr(hand, "stream_route", lambda *a: "vec16")
    with pytest.raises(RuntimeError, match="vec16 route"):
        hand.stream_sum3(x[1:], y[1:], x[1:])


def test_stream_kernels_refuse_partial_overlap(card):
    buf = rand(card, (300,), torch.float32, seed=4)
    with pytest.raises(ValueError, match="overlaps"):
        hand.daxpy(2.0, buf[:200], buf[100:], out=buf[50:250])
    with pytest.raises(ValueError, match="shape"):
        hand.stream_sum3(buf[:10], buf[:10], buf[:11])


def test_microbench_groups_on_card(card, capsys):
    hand.reset_launch_counts()
    recs = microbench.run_groups(
        ["daxpy", "ceiling", "streams"], card,
        daxpy={"sizes": (1 << 16,), "chain_n": 1 << 16},
        ceiling={"n": 1 << 16}, streams={"n": 1 << 16, "n_big": 1 << 18})
    capsys.readouterr()
    counts = hand.launch_counts()
    # dispatch_rate 1 + 100 + 1100 calls; chain_rate 3 + n_short + n_long;
    # the ceiling fit one dispatch_rate per kernel per pair
    ceiling = microbench.CEILING_PAIRS * 1201
    assert counts["daxpy"] == 1201 + 2 * 1203 + ceiling + 1103 + 333
    assert counts["stream_scale"] == ceiling + 1103
    assert counts["stream_sum3"] == 1103
    # at this size every launch is overhead-bound, so the stream-count
    # fit's slope is noise and may come out negative; every measured row
    # is a positive rate
    assert len(recs) == 12
    assert all(r["value"] > 0 for r in recs if "_fit_" not in r["metric"])


def test_daxpy_drivers_on_card(card, capsys):
    hand.reset_launch_counts()
    assert daxpy.main(["--n", "100003", "--dtype", "float64"]) == 0
    assert mpi_daxpy.main(["--n-total", "8192", "--ranks", "4"]) == 0
    for extra in ([], ["--space", "managed", "--barrier"],
                  ["--init", "device"]):
        assert mpi_daxpy_nvtx.main(["--n-per-node", "65536", "--dtype",
                                    "float64"] + extra) == 0
    assert gather_inplace.main(["--n-per-rank", "4096"]) == 0
    assert envprobe.main(["--verbose"]) == 0
    out = capsys.readouterr().out
    assert "FAIL" not in out and "0/1 ALLSUM = 32768.500000" in out
    assert not any(hand.launch_counts().values())


# ---------------------------------------------------------------------------
# flash attention: the hand kernel against its plain version
# ---------------------------------------------------------------------------

#: f32 HIGHEST: the carry within rtol/atol 1e-5 of the plain version (the
#: dot products and softmax sums run in another order); DEFAULT: the
#: normalised output within 8e-3 (bf16: P rounded to bf16) and 5e-3
#: (TF32 operands) of the plain version at HIGHEST
FLASH_DEFAULT_ATOL = {torch.bfloat16: 8e-3, torch.float32: 5e-3}


def flash_case(card, L, Lk, d, dtype, seed):
    q, k, v = (rand(card, shape, dtype, seed + i)
               for i, shape in enumerate(((L, d), (Lk, d), (Lk, d))))
    m = rand(card, (L, 1), torch.float32, seed + 3)
    l = rand(card, (L, 1), torch.float32, seed + 4).abs() + 0.5
    acc = rand(card, (L, d), torch.float32, seed + 5)
    return q, k, v, m, l, acc


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L,Lk,d", [(1, 1, 4), (7, 64, 17), (100, 300, 64),
                                    (257, 64, 128), (130, 300, 256)])
@pytest.mark.parametrize("causal,offs", [(False, (0, 0, 1)),
                                         (True, (0, 0, 1)),
                                         (True, (1000, 0, 1)),
                                         (True, (0, 5000, 1)),
                                         (True, (90, 40, 4))])
def test_flash_block_highest_matches_plain(card, dtype, L, Lk, d, causal,
                                           offs):
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, m, l, acc = flash_case(card, L, Lk, d, dtype, seed=L + d)
    q_off, k_off, stride = offs
    kw = dict(scale=d**-0.5, causal=causal, pos_stride=stride)
    want = hand.flash_attention_block_ref(q, k, v, m, l, acc, q_off, k_off,
                                          **kw)
    before = hand.flash_attention_block.launches
    got = hand.flash_attention_block(q, k, v, m, l, acc, q_off, k_off, **kw)
    torch.cuda.synchronize(card)
    assert hand.flash_attention_block.launches == before + 1
    assert got[0].data_ptr() == m.data_ptr()  # in place
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("L,d", [(7, 4), (257, 64), (300, 128), (64, 256)])
def test_flash_attention_default_matches_plain(card, dtype, causal, L, d):
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v = (rand(card, (L, d), dtype, s) for s in (1, 2, 3))
    want = hand.flash_attention_ref(q, k, v, causal=causal)
    got = hand.flash_attention(q, k, v, causal=causal, precision="default")
    torch.cuda.synchronize(card)
    err = (got.float() - want.float()).abs().max().item()
    # compared in the output dtype; a bf16 output adds its own rounding
    tol = FLASH_DEFAULT_ATOL[dtype] + (2.0**-8 * want.float().abs().max()
                                       .item() if dtype == torch.bfloat16
                                       else 0.0)
    assert err <= tol, err


def test_flash_attention_heads_layout_one_launch(card):
    q, k, v = (rand(card, (200, 4, 32), torch.float32, s) for s in (1, 2, 3))
    before = hand.flash_attention_block.launches
    got = hand.flash_attention(q, k, v, causal=True)
    assert hand.flash_attention_block.launches == before + 1
    want = hand.flash_attention_ref(q, k, v, causal=True)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


# the wgmma route: bf16 DEFAULT at d <= 128, every operand in 16-byte
# chunks (TMA loads, a producer warpgroup, wgmma products)
WG_OFFSETS = [(False, (0, 0, 1)), (True, (0, 0, 1)), (True, (1000, 37, 1)),
              (True, (3, 1, 4)), (True, (0, 10**6, 1))]


def wg_routes():
    return dict(hand.flash_attention_block.launches_by_route)


@pytest.mark.parametrize("L,Lk,d", [(1, 1, 128), (7, 65, 128),
                                    (65, 129, 64), (300, 1000, 128),
                                    (129, 7, 8), (8191, 300, 72)])
@pytest.mark.parametrize("causal,offs", WG_OFFSETS)
def test_flash_wgmma_route_matches_plain(card, L, Lk, d, causal, offs):
    """Ragged L and Lk, d that leaves the second 64-column half empty or
    partly filled, causal offsets (the striped ring's stride, a fully
    masked block): the normalised carry within 8e-3 of the plain version
    at HIGHEST, the launch counted on the wgmma route."""
    q, k, v, m, l, acc = flash_case(card, L, Lk, d, torch.bfloat16,
                                    seed=L + d)
    kw = dict(scale=d**-0.5, causal=causal, pos_stride=offs[2])
    want = hand.flash_attention_block_ref(q, k, v, m, l, acc, *offs[:2], **kw)
    before = wg_routes()
    got = hand.flash_attention_block(q, k, v, m, l, acc, *offs[:2],
                                     precision="default", **kw)
    torch.cuda.synchronize(card)
    assert wg_routes()["wgmma"] == before["wgmma"] + 1
    err = (got[2] / got[1] - want[2] / want[1]).abs().max().item()
    assert err <= FLASH_DEFAULT_ATOL[torch.bfloat16], err


@pytest.mark.parametrize("heads_outer", [False, True])
@pytest.mark.parametrize("d", [64, 128])
def test_flash_wgmma_route_heads_layouts(card, heads_outer, d):
    """(L, H, d) in one launch with the heads inside the rows (head stride
    d) and outside them (head stride L·d): both tensor-map orders."""
    if heads_outer:
        q, k, v = (rand(card, (4, 333, d), torch.bfloat16, s).transpose(0, 1)
                   for s in (1, 2, 3))
    else:
        q, k, v = (rand(card, (333, 4, d), torch.bfloat16, s)
                   for s in (1, 2, 3))
    before = wg_routes()
    got = hand.flash_attention(q, k, v, causal=True, precision="default")
    torch.cuda.synchronize(card)
    assert wg_routes()["wgmma"] == before["wgmma"] + 1
    want = hand.flash_attention_ref(q, k, v, causal=True)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 8e-3 + 2.0**-8 * want.float().abs().max().item(), err


def test_flash_routes_counted_per_geometry(card):
    """bf16 DEFAULT aligned on wgmma, misaligned or d > 128 on mma, f32
    DEFAULT on mma; f32 HIGHEST aligned on tf32x3, misaligned or d > 128
    on fma, bf16 HIGHEST on fma: one launch each, on its route."""
    base = rand(card, (64 * 128 + 4,), torch.bfloat16, seed=1)
    base32 = rand(card, (64 * 128 + 2,), torch.float32, seed=6)
    cases = [
        (rand(card, (64, 128), torch.bfloat16, 2), "default", "wgmma"),
        (base[4:].view(64, 128), "default", "mma"),  # 8 bytes off
        (rand(card, (64, 136), torch.bfloat16, 3), "default", "mma"),
        (rand(card, (64, 128), torch.float32, 4), "default", "mma"),
        (rand(card, (64, 128), torch.bfloat16, 5), "highest", "fma"),
        (rand(card, (64, 128), torch.float32, 7), "highest", "tf32x3"),
        (base32[2:].view(64, 128), "highest", "fma"),  # 8 bytes off
        (rand(card, (64, 136), torch.float32, 8), "highest", "fma"),
    ]
    for q, precision, route in cases:
        assert hand.flash_route(q.dtype, precision, q.shape[-1],
                                hand.flash_aligned(q.shape[-1], q)) == route
        before = wg_routes()
        hand.flash_attention(q, q, q, precision=precision)
        after = wg_routes()
        assert {r: after[r] - before[r] for r in after} == \
            {r: int(r == route) for r in after}


def test_flash_launch_refuses_another_route(card, monkeypatch):
    """The launcher checks the route it is given: a wrapper that named
    another route than the rule's gets an error, never a fallback."""
    q = rand(card, (64, 128), torch.float32, seed=1)
    monkeypatch.setattr(hand, "flash_route", lambda *a: "wgmma")
    with pytest.raises(RuntimeError, match="wgmma route"):
        hand.flash_attention(q, q, q, precision="default")
    with pytest.raises(RuntimeError, match="wgmma route"):
        hand.fused_ring_attention(q, q, q, precision="default")
    # code 3 (tf32x3) only where the rule gives it: not for bf16, nor for
    # f32 at d > 128; and the old body no longer where it does
    b = rand(card, (64, 128), torch.bfloat16, seed=2)
    wide = rand(card, (64, 136), torch.float32, seed=3)
    monkeypatch.setattr(hand, "flash_route", lambda *a: "tf32x3")
    for t in (b, wide):
        with pytest.raises(RuntimeError, match="tf32x3 route"):
            hand.flash_attention(t, t, t, precision="highest")
        with pytest.raises(RuntimeError, match="tf32x3 route"):
            hand.fused_ring_attention(t, t, t, precision="highest")
    monkeypatch.setattr(hand, "flash_route", lambda *a: "fma")
    with pytest.raises(RuntimeError, match="fma route"):
        hand.flash_attention(q, q, q, precision="highest")
    with pytest.raises(RuntimeError, match="fma route"):
        hand.fused_ring_attention(q, q, q, precision="highest")


def carry_close(got, want, tol=1e-5):
    """chip_smoke's HIGHEST rule: m, l and acc within rtol/atol ``tol``,
    acc's atol times its row's weight l where l > 1 (acc sums up to Lk
    terms of size p·|v|), -inf rows equal."""
    for g, w, what in zip(got, want, ("m", "l", "acc")):
        atol = tol * want[1].clamp(min=1.0) if what == "acc" else tol
        ok = ((g - w).abs() <= atol + tol * w.abs()) | (g == w)
        assert bool(ok.all()), (what, float((g - w).abs().max()))


# the tf32x3 route: f32 HIGHEST at d <= 128, every operand in 16-byte
# chunks (the wgmma route's shape, three TF32 passes a product)
@pytest.mark.parametrize("L,Lk,d", [(1, 1, 128), (7, 65, 128),
                                    (65, 129, 64), (300, 1000, 128),
                                    (129, 7, 4), (8191, 300, 72),
                                    (100, 257, 96)])
@pytest.mark.parametrize("causal,offs", WG_OFFSETS)
def test_flash_tf32x3_route_matches_plain(card, L, Lk, d, causal, offs):
    """Ragged L and Lk, d that leaves quarters of the 128 columns empty or
    partly filled, causal offsets (the striped ring's stride, a fully
    masked block): the carry within chip_smoke's HIGHEST tolerance of the
    plain version, the launch counted on the tf32x3 route."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, m, l, acc = flash_case(card, L, Lk, d, torch.float32,
                                    seed=L + d)
    kw = dict(scale=d**-0.5, causal=causal, pos_stride=offs[2])
    want = hand.flash_attention_block_ref(q, k, v, m, l, acc, *offs[:2], **kw)
    before = wg_routes()
    got = hand.flash_attention_block(q, k, v, m, l, acc, *offs[:2], **kw)
    torch.cuda.synchronize(card)
    assert wg_routes()["tf32x3"] == before["tf32x3"] + 1
    carry_close(got, want)


@pytest.mark.parametrize("heads_outer", [False, True])
@pytest.mark.parametrize("d", [64, 128])
def test_flash_tf32x3_route_heads_layouts(card, heads_outer, d):
    """(L, H, d) f32 in one launch, both tensor-map orders."""
    if heads_outer:
        q, k, v = (rand(card, (4, 333, d), torch.float32, s).transpose(0, 1)
                   for s in (1, 2, 3))
    else:
        q, k, v = (rand(card, (333, 4, d), torch.float32, s)
                   for s in (1, 2, 3))
    before = wg_routes()
    got = hand.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize(card)
    assert wg_routes()["tf32x3"] == before["tf32x3"] + 1
    want = hand.flash_attention_ref(q, k, v, causal=True)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("k", [None, 2, 4, 8])
@pytest.mark.parametrize("causal,stripe", [(False, False), (True, False),
                                           (True, True)])
def test_fused_ring_tf32x3_route(card, k, causal, stripe):
    """The fused kernel on the tf32x3 route (its splitters beside the send
    warp): bit for bit the pipelined tier's flash launches on the same
    route, counted on it, and within 1e-5 of the plain version."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q, kk, v = (rand(card, (1000, 128), torch.float32, s) for s in (1, 2, 3))
    kw = dict(causal=causal, stripe=stripe, precision="highest")
    before = dict(hand.fused_ring_attention.launches_by_route)
    got = hand.fused_ring_attention(q, kk, v, self_ring=k, **kw)
    torch.cuda.synchronize(card)
    assert hand.fused_ring_attention.launches_by_route["tf32x3"] == \
        before["tf32x3"] + 1
    flash_before = wg_routes()
    flash = hand.fused_ring_world_ref([(q, kk, v)] * (k or 1), kernel=True,
                                      **kw)[0]
    assert wg_routes()["tf32x3"] == flash_before["tf32x3"] + (k or 1) ** 2
    assert torch.equal(got, flash)
    want = hand.fused_ring_attention_ref(q, kk, v, self_ring=k, **kw)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("k", [None, 2, 4, 8])
@pytest.mark.parametrize("causal,stripe", [(False, False), (True, False),
                                           (True, True)])
def test_fused_ring_wgmma_route(card, k, causal, stripe):
    """The fused kernel on the wgmma route (its send warp, the producer's
    proxy fence after each arrival): bit for bit the pipelined tier's
    flash launches on the same route, counted on it."""
    q, kk, v = (rand(card, (1000, 128), torch.bfloat16, s) for s in (1, 2, 3))
    kw = dict(causal=causal, stripe=stripe, precision="default")
    before = dict(hand.fused_ring_attention.launches_by_route)
    got = hand.fused_ring_attention(q, kk, v, self_ring=k, **kw)
    torch.cuda.synchronize(card)
    assert hand.fused_ring_attention.launches_by_route["wgmma"] == \
        before["wgmma"] + 1
    flash_before = wg_routes()
    flash = hand.fused_ring_world_ref([(q, kk, v)] * (k or 1), kernel=True,
                                      **kw)[0]
    assert wg_routes()["wgmma"] == flash_before["wgmma"] + (k or 1) ** 2
    assert torch.equal(got, flash)


# ---------------------------------------------------------------------------
# the routes of the probe (cluster / l2) and of the dual step (regs / smem)
# ---------------------------------------------------------------------------

#: (shape, dtype, route): blocks on clusters of 1, 2, 4, 8 and 16 CTAs,
#: ragged against the slab and the vector, and blocks no cluster holds
PROBE_ROUTE_CASES = [
    ((2, 37, 200), torch.float32, "cluster"),
    ((1000, 40), torch.float32, "cluster"),
    ((997, 100), torch.float32, "cluster"),
    ((250, 520), torch.float32, "cluster"),
    ((515, 500), torch.float32, "cluster"),
    ((2, 512, 512), torch.float32, "cluster"),
    ((1023, 130), torch.bfloat16, "cluster"),
    ((2, 512, 512), torch.bfloat16, "cluster"),
    ((300, 2000), torch.bfloat16, "cluster"),
    ((700, 1000), torch.float32, "l2"),
    ((1030, 1024), torch.bfloat16, "l2"),
]


@pytest.mark.parametrize("shape, dtype, route", PROBE_ROUTE_CASES)
@pytest.mark.parametrize("mix", hand.ALU_PROBE_MIXES)
def test_probe_routes_match_plain(card, mix, shape, dtype, route):
    """Each route against the plain version: bit for bit but for the dual
    mixes (their tolerance), each launch counted on its route."""
    z = rand(card, shape, dtype, seed=21)
    assert hand.probe_route(z, mix) == route
    for reps in (1, 3):
        before = dict(hand.alu_probe.launches_by_route)
        got = hand.alu_probe(z, reps, mix, se=0.05)
        shifts = []
        want = hand.alu_probe_ref(z, reps, mix, se=0.05, shifts=shifts)
        torch.cuda.synchronize(card)
        assert hand.alu_probe.launches_by_route == before | {
            route: before[route] + 1}
        if mix.startswith("dualdim"):
            tol = hand.alu_probe_tolerance(
                dtype, reps, float(want.float().abs().max()), max(shifts))
            err = float((got.float() - want.float()).abs().max())
            assert err <= tol, (reps, err, tol)
            assert torch.equal(got, hand.alu_probe(z, reps, mix, se=0.05))
        else:
            assert torch.equal(got, want), reps


@pytest.mark.parametrize("shape, dtype, route", [
    ((515, 500), torch.float32, "cluster"),
    ((2, 512, 512), torch.bfloat16, "cluster"),
    ((700, 1000), torch.float32, "l2")])
@pytest.mark.parametrize("mix", hand.ALU_PROBE_MIXES)
def test_probe_chain_property_on_both_routes(card, mix, shape, dtype, route):
    z = rand(card, shape, dtype, seed=22)
    assert hand.probe_route(z, mix) == route
    once = hand.alu_probe(z, 7, mix, se=0.05)
    twice = hand.alu_probe(hand.alu_probe(z, 3, mix, se=0.05), 4, mix,
                           se=0.05)
    assert torch.equal(once, twice)
    assert not torch.equal(once, z)


def test_probe_block_over_a_cluster_takes_l2(card):
    """A block no cluster's shared memory holds runs on the l2 route;
    one that fits takes the cluster, with one cluster a block."""
    hand.reset_launch_counts()
    big = rand(card, (1024, 1024), torch.float32, seed=23)
    assert hand.probe_cluster(1024, 1024, torch.float32) is None
    got = hand.alu_probe(big, 2, "step5_d0")
    assert torch.equal(got, hand.alu_probe_ref(big, 2, "step5_d0"))
    z = rand(card, (3, 512, 512), torch.float32, seed=24)
    hand.alu_probe(z, 2, "heat5")
    assert hand.route_counts()["alu_probe"] == {"l2": 1, "cluster": 1}
    cs = hand.probe_cluster(512, 512, torch.float32)[0]
    assert hand.alu_probe.last_ctas == 3 * cs


def test_probe_clusters_fill_the_card(card):
    """The main path's batch is the clusters the card holds at once."""
    for dtype in (torch.float32, torch.bfloat16):
        n = hand.alu_probe_clusters(512, 512, dtype)
        assert n >= 1
        assert microbench.probe_batch(512, 512, card, dtype) == n
    assert hand.alu_probe_clusters(1024, 1024, torch.float32) == 0


def test_probe_launch_refuses_another_route(card, monkeypatch):
    z = rand(card, (64, 256), torch.float32, seed=25)
    big = rand(card, (1024, 1024), torch.float32, seed=26)
    monkeypatch.setattr(hand, "probe_route", lambda *a, **k: "l2")
    with pytest.raises(RuntimeError, match="l2 route"):
        hand.alu_probe(z, 2, "step5_d1")
    monkeypatch.setattr(hand, "probe_route", lambda *a, **k: "cluster")
    with pytest.raises(RuntimeError, match="cluster route"):
        hand.alu_probe(big, 2, "step5_d1")


#: (shape, dtype, offset in elements, route)
DUAL_ROUTE_CASES = [
    ((68, 52), torch.float32, 0, "smem"),
    ((301, 136), torch.float32, 0, "smem"),
    ((1000, 777), torch.float32, 0, "smem"),
    ((130, 260), torch.float32, 2, "smem"),
    ((2052, 1028), torch.float32, 0, "smem"),
    ((68, 52), torch.bfloat16, 0, "regs"),
    ((301, 136), torch.bfloat16, 0, "regs"),
    ((1000, 777), torch.bfloat16, 0, "smem"),
    ((130, 260), torch.bfloat16, 4, "regs"),
    ((130, 260), torch.bfloat16, 2, "smem"),
    ((130, 264), torch.bfloat16, 4, "regs"),
    ((1030, 1032), torch.bfloat16, 0, "regs"),
    ((2052, 1028), torch.bfloat16, 0, "regs"),
    ((301, 136), torch.float64, 0, "smem"),
]


@pytest.mark.parametrize("shape, dtype, off, route", DUAL_ROUTE_CASES)
@pytest.mark.parametrize("lean", [False, True])
def test_dual_routes_match_plain(card, shape, dtype, off, route, lean):
    """Both routes against the plain version, both bodies: the
    derivatives bit for bit, the residual within RESIDUAL_RTOL and the
    same from run to run, each launch counted on its route."""
    n = shape[0] * shape[1]
    z = rand(card, (n + off,), dtype, seed=27)[off:].view(shape)
    assert hand.dual_route(z) == route
    before = dict(hand.dual_dim_step.launches_by_route)
    gx, gy, gr = hand.dual_dim_step(z, 2, 1.5, 0.75, lean=lean)
    wx, wy, wr = hand.dual_dim_step_ref(z, 2, 1.5, 0.75, lean=lean)
    torch.cuda.synchronize(card)
    assert hand.dual_dim_step.launches_by_route == before | {
        route: before[route] + 1}
    assert torch.equal(gx, wx) and torch.equal(gy, wy)
    assert gr.dtype == dtype
    assert abs(float(gr) - float(wr)) <= hand.RESIDUAL_RTOL[dtype] * abs(
        float(wr))
    assert torch.equal(gr, hand.dual_dim_step(z, 2, 1.5, 0.75, lean=lean)[2])


def test_dual_launch_refuses_another_route(card, monkeypatch):
    z = rand(card, (68, 52), torch.bfloat16, seed=28)
    odd = rand(card, (68, 53), torch.bfloat16, seed=29)
    monkeypatch.setattr(hand, "dual_route", lambda *a, **k: "smem")
    with pytest.raises(RuntimeError, match="smem route"):
        hand.dual_dim_step(z, 2, 1.0, 1.0)
    monkeypatch.setattr(hand, "dual_route", lambda *a, **k: "regs")
    with pytest.raises(RuntimeError, match="regs route"):
        hand.dual_dim_step(odd, 2, 1.0, 1.0)
    for other in (torch.float32, torch.float64):
        with pytest.raises(RuntimeError, match="regs route"):
            hand.dual_dim_step(z.to(other), 2, 1.0, 1.0)


# ---------------------------------------------------------------------------
# the ALU probe, the halo staging copies, the dual step's lean body
# ---------------------------------------------------------------------------

_BIT_EXACT_MIXES = [m for m in hand.ALU_PROBE_MIXES
                    if not m.startswith("dualdim")]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8, 128), (37, 200), (3, 70, 130),
                                   (512, 512)])
@pytest.mark.parametrize("mix", _BIT_EXACT_MIXES)
def test_probe_kernel_matches_plain_bit_for_bit(card, mix, shape, dtype):
    z = rand(card, shape, dtype, seed=11)
    for reps, se in ((1, 0.05), (3, 0.05), (4, 1e-9)):
        before = hand.alu_probe.launches
        got = hand.alu_probe(z, reps, mix, se=se)
        want = hand.alu_probe_ref(z, reps, mix, se=se)
        torch.cuda.synchronize(card)
        assert hand.alu_probe.launches == before + 1
        assert got.device == card and hand.alu_probe.last_ctas >= 1
        assert torch.equal(got, want), (reps, se)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8, 128), (37, 200), (3, 70, 130),
                                   (512, 512)])
@pytest.mark.parametrize("mix", ["dualdim", "dualdim_lean"])
def test_probe_dual_mixes_within_tolerance(card, mix, shape, dtype):
    z = rand(card, shape, dtype, seed=12)
    for reps, se in ((1, 0.05), (3, 0.05), (16, 0.05), (4, 1e-9)):
        shifts = []
        got = hand.alu_probe(z, reps, mix, se=se)
        want = hand.alu_probe_ref(z, reps, mix, se=se, shifts=shifts)
        tol = hand.alu_probe_tolerance(
            dtype, reps, float(want.float().abs().max()), max(shifts))
        err = float((got.float() - want.float()).abs().max())
        assert err <= tol, (reps, se, err, tol)
        # the same bits from run to run: the sums have a fixed order
        assert torch.equal(got, hand.alu_probe(z, reps, mix, se=se))


@pytest.mark.parametrize("mix", hand.ALU_PROBE_MIXES)
def test_probe_chain_property_on_card(card, mix):
    z = rand(card, (2, 100, 300), torch.float32, seed=13)
    once = hand.alu_probe(z, 7, mix, se=0.05)
    twice = hand.alu_probe(hand.alu_probe(z, 3, mix, se=0.05), 4, mix,
                           se=0.05)
    assert torch.equal(once, twice)
    assert not torch.equal(once, z)


def test_probe_capacity_guard_on_card(card):
    l2 = hand.alu_probe_l2_bytes()
    assert l2 > 0
    n = l2 // 4 // 1024 // 2 + 1024  # one buffer just over half the L2
    z = torch.zeros((n, 1024), device=card)
    before = hand.alu_probe.launches
    with pytest.raises(ValueError, match="L2"):
        hand.alu_probe(z, 2, "fma")
    with pytest.raises(ValueError, match="contiguous"):
        hand.alu_probe(torch.zeros((64, 256), device=card)[:, ::2], 2)
    assert hand.alu_probe.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("n_bnd", [1, 2, 8])
@pytest.mark.parametrize("shape", [(16, 16), (37, 201), (300, 1028)])
def test_pack_unpack_kernels_match_plain(card, dtype, axis, n_bnd, shape):
    z = rand(card, shape, dtype, seed=14)
    before = hand.launch_counts()
    lo, hi = hand.pack_edges(z, axis, n_bnd)
    wlo, whi = hand.pack_edges_ref(z, axis, n_bnd)
    assert lo.is_contiguous() and hi.is_contiguous()
    assert torch.equal(lo, wlo) and torch.equal(hi, whi)
    # the round trip of the JAX package's test_pack_unpack_roundtrip:
    # ghosts <- the edges; the interior untouched
    got = hand.unpack_ghosts(z.clone(), lo, hi, axis, n_bnd)
    want = hand.unpack_ghosts_ref(z.clone(), lo, hi, axis, n_bnd)
    torch.cuda.synchronize(card)
    assert torch.equal(got, want)
    n = shape[axis]
    assert torch.equal(got.narrow(axis, 0, n_bnd), lo)
    assert torch.equal(got.narrow(axis, n - n_bnd, n_bnd), hi)
    assert torch.equal(got.narrow(axis, n_bnd, n - 2 * n_bnd),
                       z.narrow(axis, n_bnd, n - 2 * n_bnd))
    after = hand.launch_counts()
    assert after["pack_edges"] == before["pack_edges"] + 1
    assert after["unpack_ghosts"] == before["unpack_ghosts"] + 1


def test_pack_unpack_refuse_bad_operands(card):
    z = rand(card, (16, 16), torch.float32, seed=15)
    with pytest.raises(ValueError, match="contiguous"):
        hand.pack_edges(z.T, 0, 2)
    with pytest.raises(ValueError, match="bands"):
        hand.pack_edges(z[:3].contiguous(), 0, 2)
    lo, hi = hand.pack_edges(z, 0, 2)
    with pytest.raises(ValueError, match="share storage"):
        hand.unpack_ghosts(z, z[2:4], hi, 0, 2)
    with pytest.raises(ValueError, match="must be"):
        hand.unpack_ghosts(z, lo[:1], hi, 0, 2)


def pack_routes():
    return {name: dict(fn.launches_by_route) for name, fn in (
        ("pack_edges", hand.pack_edges),
        ("unpack_ghosts", hand.unpack_ghosts))}


def pack_cases():
    """(dtype, shape, axis, n_bnd, route): 2-, 4- and 8-byte elements on
    both axes, n_bnd 1, 2, 3 and 8, every route; odd widths (seams
    straddling sectors), one and two rows along axis 1 (the first and
    last seams), extents of 2·n_bnd."""
    f32, bf16, f64 = torch.float32, torch.bfloat16, torch.float64
    return [
        (f32, (37, 64), 0, 2, "vec16"), (f32, (37, 66), 0, 1, "vec8"),
        (f32, (37, 201), 0, 3, "scalar"), (f32, (301, 1028), 0, 8, "vec16"),
        (bf16, (37, 64), 0, 3, "vec16"), (bf16, (37, 68), 0, 2, "vec8"),
        (bf16, (37, 70), 0, 2, "scalar"), (f64, (37, 64), 0, 1, "vec16"),
        (f64, (37, 65), 0, 8, "scalar"), (f32, (4, 64), 0, 2, "vec16"),
        (f32, (45, 1028), 1, 1, "scalar"), (f32, (45, 1028), 1, 2, "vec8"),
        (f32, (45, 1028), 1, 3, "scalar"), (f32, (45, 1028), 1, 4, "vec16"),
        (f32, (45, 1028), 1, 8, "vec16"), (f32, (45, 1026), 1, 2, "vec8"),
        (f32, (45, 1027), 1, 2, "scalar"), (f32, (301, 1027), 1, 8, "scalar"),
        (bf16, (45, 1028), 1, 2, "scalar"), (bf16, (45, 1028), 1, 4, "vec8"),
        (bf16, (45, 1028), 1, 8, "vec8"), (bf16, (45, 1024), 1, 8, "vec16"),
        (bf16, (45, 1027), 1, 4, "scalar"), (f64, (45, 1028), 1, 1, "scalar"),
        (f64, (45, 1028), 1, 2, "vec16"), (f64, (45, 1027), 1, 3, "scalar"),
        (f64, (45, 1028), 1, 8, "vec16"), (f32, (1, 1028), 1, 2, "vec8"),
        (f32, (2, 1028), 1, 2, "vec8"), (f32, (1, 1028), 1, 8, "vec16"),
        (f32, (2, 1027), 1, 3, "scalar"), (bf16, (1, 1028), 1, 4, "vec8"),
        (f64, (2, 1028), 1, 1, "scalar"), (f32, (45, 4), 1, 2, "vec8"),
        (f32, (3000, 8196), 1, 2, "vec8"), (f32, (1028, 8192), 0, 2, "vec16"),
    ]


@pytest.mark.parametrize("dtype,shape,axis,n_bnd,route", pack_cases())
def test_pack_unpack_routes_match_plain(card, dtype, shape, axis, n_bnd,
                                        route):
    """Each route bit for bit against the plain versions, pack and unpack
    each counted once on the route the rule names."""
    z = rand(card, shape, dtype, seed=shape[1] + 7 * n_bnd + axis)
    assert hand.pack_route(z, axis, n_bnd) == route
    before = pack_routes()
    lo, hi = hand.pack_edges(z, axis, n_bnd)
    wlo, whi = hand.pack_edges_ref(z, axis, n_bnd)
    ghosts = [rand(card, lo.shape, dtype, seed=s) for s in (1, 2)]
    got = hand.unpack_ghosts(z.clone(), *ghosts, axis, n_bnd)
    want = hand.unpack_ghosts_ref(z.clone(), *ghosts, axis, n_bnd)
    torch.cuda.synchronize(card)
    assert torch.equal(lo, wlo) and torch.equal(hi, whi)
    assert torch.equal(got, want)
    after = pack_routes()
    for name in after:
        assert {r: after[name][r] - before[name][r] for r in after[name]} \
            == {r: int(r == route) for r in after[name]}


@pytest.mark.parametrize("dtype,off,narrow", [
    (torch.float32, 1, "scalar"), (torch.float32, 2, "vec8"),
    (torch.bfloat16, 1, "scalar"), (torch.bfloat16, 4, "vec8"),
    (torch.float64, 1, "scalar")])
@pytest.mark.parametrize("axis", [0, 1])
def test_pack_view_off_16_bytes_takes_a_narrower_route(card, dtype, off,
                                                       narrow, axis):
    """The same array as a view ``off`` elements past a 16-byte boundary
    (and unpack's buffers likewise): a narrower route, still bit for
    bit, counted on that route."""
    item = torch.empty((), dtype=dtype).element_size()
    n_bnd = 16 // item
    shape = (40, 512 // item)
    whole = rand(card, (shape[0] * shape[1] + off,), dtype, seed=off + axis)
    z = whole[off:].view(shape)
    assert hand.pack_route(z.clone(), axis, n_bnd) == "vec16"
    assert hand.pack_route(z, axis, n_bnd) == narrow
    before = pack_routes()
    lo, hi = hand.pack_edges(z, axis, n_bnd)
    wlo, whi = hand.pack_edges_ref(z, axis, n_bnd)
    bufs = [rand(card, (lo.numel() + off,), dtype, seed=s)[off:]
            .view(lo.shape) for s in (3, 4)]
    assert hand.pack_route(z, axis, n_bnd, *(b.data_ptr() for b in bufs)) \
        == narrow
    want = hand.unpack_ghosts_ref(z.clone(), *bufs, axis, n_bnd)
    got = hand.unpack_ghosts(z, *bufs, axis, n_bnd)
    torch.cuda.synchronize(card)
    assert torch.equal(lo, wlo) and torch.equal(hi, whi)
    assert torch.equal(got, want)
    after = pack_routes()
    for name in after:
        assert after[name][narrow] == before[name][narrow] + 1


def test_pack_launch_refuses_another_route(card, monkeypatch):
    """The launcher checks the route it is given: a wrapper that named
    another route than the rule's gets an error, never a fallback."""
    z = rand(card, (40, 64), torch.float32, seed=1)
    lo, hi = hand.pack_edges(z, 0, 2)
    for wrong in ("scalar", "vec8"):
        monkeypatch.setattr(hand, "_pack_route", lambda *a, w=wrong: w)
        with pytest.raises(RuntimeError, match=f"{wrong} route"):
            hand.pack_edges(z, 0, 2)
        with pytest.raises(RuntimeError, match=f"{wrong} route"):
            hand.unpack_ghosts(z, lo, hi, 0, 2)
    monkeypatch.setattr(hand, "_pack_route", lambda *a: "vec16")
    with pytest.raises(RuntimeError, match="vec16 route"):
        hand.pack_edges(rand(card, (40, 65), torch.float32, seed=2), 0, 2)


@pytest.mark.parametrize("axis,n_bnd,width,route", [
    (0, 2, 100, "vec16"), (0, 8, 112, "vec16"), (0, 2, 102, "vec8"),
    (0, 2, 101, "scalar"), (1, 2, 100, "vec8"), (1, 4, 100, "vec16"),
    (1, 8, 112, "vec16"), (1, 2, 101, "scalar"), (1, 3, 100, "scalar")])
def test_hand_staged_exchange_equals_direct(card, axis, n_bnd, width, route):
    z = rand(card, (64 + 2 * n_bnd, width), torch.float32, seed=16)
    assert hand.pack_route(z, axis, n_bnd) == route
    hand.reset_launch_counts()
    got = TH.halo_exchange(z.clone(), axis, n_bnd, True, "device",
                           kernel="hand")
    counts = hand.launch_counts()
    assert counts["pack_edges"] == 1 and counts["unpack_ghosts"] == 1
    assert all(r[route] == 1 for r in pack_routes().values())
    want = TH.halo_exchange(z.clone(), axis, n_bnd, True, "direct")
    assert torch.equal(got, want)
    # non-periodic at world=1: nothing moves, nothing launches
    hand.reset_launch_counts()
    same = TH.halo_exchange(z.clone(), axis, n_bnd, False, "device",
                            kernel="hand")
    assert torch.equal(same, z) and not any(hand.launch_counts().values())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
@pytest.mark.parametrize("shape", [(68, 52), (301, 133)])
def test_dual_dim_step_lean_kernel_matches_plain(card, dtype, shape):
    z = rand(card, shape, dtype, seed=17)
    before = hand.dual_dim_step.launches
    gx, gy, gr = hand.dual_dim_step(z, 2, 1.5, 0.75, lean=True)
    wx, wy, wr = hand.dual_dim_step_ref(z, 2, 1.5, 0.75, lean=True)
    torch.cuda.synchronize(card)
    assert hand.dual_dim_step.launches == before + 1
    assert torch.equal(gx, wx) and torch.equal(gy, wy)
    assert gr.dtype == dtype and gr.device == card
    assert abs(float(gr) - float(wr)) <= hand.RESIDUAL_RTOL[dtype] * abs(
        float(wr))
    # the two bodies differ by association only
    rx, _, rr = hand.dual_dim_step(z, 2, 1.5, 0.75, lean=False)
    eps = {torch.float64: 1e-12, torch.float32: 1e-5,
           torch.bfloat16: 0.1}[dtype]
    assert float((gx.double() - rx.double()).abs().max()) <= eps * max(
        1.0, float(rx.double().abs().max()))
    assert abs(float(gr) - float(rr)) <= max(eps, 2.0**-6) * abs(float(rr))


def test_vpu_group_and_stencil1d_on_card(card, capsys):
    hand.reset_launch_counts()
    recs = microbench.run_groups(
        ["vpu"], card, vpu={"H_": 64, "W": 128, "batch": 2, "iters": 10,
                            "n": 256, "long_steps": 100, "reps_div": 16})
    counts = hand.launch_counts()
    # 6 (mix, dtype) probes x 3 reps values x chain_rate's 3 + 1 + 10
    assert counts["alu_probe"] == 18 * 14
    assert counts["stencil2d_iterate"] > 0
    probe_rows = [r for r in recs if r["metric"].endswith("_gops")]
    assert len(probe_rows) == 6
    assert all("cooperative launch of" in r["detail"]
               and "not an ALU ceiling" in r["detail"] for r in probe_rows)
    hand.reset_launch_counts()
    assert stencil1d.main(["--n-global", "1048576", "--staging",
                           "device"]) == 0
    out = capsys.readouterr().out
    assert "err_norm = " in out and "FAIL" not in out
    assert not any(hand.launch_counts().values())


# ---------------------------------------------------------------------------
# the RDMA ring kernels on the self-ring (world=1, one card)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("n_bnd", [1, 2, 8])
@pytest.mark.parametrize("periodic", [True, False])
@pytest.mark.parametrize("extent", [5, 40, 301])
def test_ring_halo_kernel_matches_plain(card, dtype, axis, n_bnd, periodic,
                                        extent):
    """Bit for bit against the plain self-ring copy, over five chained
    calls (the epoch counters advance); extents under 3·n_bnd take the
    staged path."""
    if extent < 2 * n_bnd:
        pytest.skip("the extent holds no two bands")
    shape = (extent, 67) if axis == 0 else (45, extent)
    z = rand(card, shape, dtype, seed=extent + n_bnd)
    want = z.clone()
    before = hand.ring_halo.launches
    for _ in range(5):
        got = hand.ring_halo(z, axis=axis, n_bnd=n_bnd, periodic=periodic)
        hand.ring_halo_ref(want, axis=axis, n_bnd=n_bnd, periodic=periodic)
    torch.cuda.synchronize(card)
    assert got is z
    assert hand.ring_halo.launches == before + 5
    assert torch.equal(z, want)


def test_ring_halo_kernel_1d_column(card):
    z = rand(card, (1000,), torch.float32, seed=3)
    want = hand.ring_halo_ref(z.clone(), n_bnd=2, periodic=True)
    hand.ring_halo(z, n_bnd=2, periodic=True)
    torch.cuda.synchronize(card)
    assert torch.equal(z, want)


# the ring halo's two routes: vec16 (16-byte vectors) and scalar

def halo_routes():
    return dict(hand.ring_halo.launches_by_route)


def halo_cases():
    """(dtype, axis, route, n_bnd, extent, other): vec16 where the row
    pitch (and on axis 1 a row's band) is whole 16-byte vectors and the
    extent is at least 3·n_bnd; scalar on odd widths, 3-wide bands and
    the staged extents 2·n_bnd and 3·n_bnd − 1."""
    cases = []
    for dtype in (torch.bfloat16, torch.float32, torch.float64):
        v = 16 // torch.empty((), dtype=dtype).element_size()
        for axis in (0, 1):
            b = v if axis == 1 else 2
            extents = (3 * b, 37 * v) if axis == 1 else (3 * b, 301)
            other = 45 if axis == 1 else 24
            cases += [(dtype, axis, "vec16", b, n, other) for n in extents]
            cases += [(dtype, axis, "scalar", 3, n, 45)
                      for n in (6, 8, 9, 301)]
    return cases


@pytest.mark.parametrize("periodic", [True, False])
@pytest.mark.parametrize("dtype,axis,route,n_bnd,extent,other", halo_cases())
def test_ring_halo_route_matches_plain(card, periodic, dtype, axis, route,
                                       n_bnd, extent, other):
    """2-, 4- and 8-byte elements on both axes and both routes, periodic
    and not, staged and not: five chained calls bit for bit the plain
    self-ring, each launch counted on its route."""
    shape = (extent, other) if axis == 0 else (other, extent)
    z = rand(card, shape, dtype, seed=extent + 7 * n_bnd + axis)
    assert hand.halo_route(z, axis, n_bnd) == route
    want = z.clone()
    before = halo_routes()
    for _ in range(5):
        hand.ring_halo(z, axis=axis, n_bnd=n_bnd, periodic=periodic)
        hand.ring_halo_ref(want, axis=axis, n_bnd=n_bnd, periodic=periodic)
    torch.cuda.synchronize(card)
    after = halo_routes()
    assert {r: after[r] - before[r] for r in after} == \
        {r: 5 * (r == route) for r in after}
    assert torch.equal(z, want)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.float64])
@pytest.mark.parametrize("axis", [0, 1])
def test_ring_halo_view_off_16_bytes_takes_scalar(card, dtype, axis):
    """A view one element off 16 bytes, of a geometry that is vec16 when
    aligned, lands on the scalar route and still matches bit for bit."""
    v = 16 // torch.empty((), dtype=dtype).element_size()
    n_bnd = v if axis == 1 else 2
    shape = (40, 8 * v) if axis == 0 else (40, 8 * v)
    base = rand(card, (shape[0] * shape[1] + 1,), dtype, seed=31 + axis)
    z = base[1:].view(shape)
    assert hand.halo_route(z.clone(), axis, n_bnd) == "vec16"
    assert hand.halo_route(z, axis, n_bnd) == "scalar"
    want = hand.ring_halo_ref(z.clone(), axis=axis, n_bnd=n_bnd,
                              periodic=True)
    before = halo_routes()
    hand.ring_halo(z, axis=axis, n_bnd=n_bnd, periodic=True)
    torch.cuda.synchronize(card)
    assert halo_routes()["scalar"] == before["scalar"] + 1
    assert torch.equal(z, want)


@pytest.mark.parametrize("shape,axis,n_bnd,dtype,route", [
    ((1028, 524288), 0, 2, torch.float32, "vec16"),
    ((524288, 1028), 1, 2, torch.float32, "scalar"),
    ((8192, 8208), 1, 8, torch.float32, "vec16"),
    ((8192, 8208), 1, 8, torch.bfloat16, "vec16"),
    ((1040, 524288), 0, 8, torch.float32, "vec16"),
    ((33554436,), 0, 2, torch.float32, "scalar")])
def test_ring_halo_main_path_operands(card, shape, axis, n_bnd, dtype,
                                      route):
    """stencil2d --rdma's two legs, the bench's rdma-chained buffer in
    both dtypes, the driver's iterate leg and stencil1d's column: each on
    its route, bit for bit the plain self-ring."""
    z = rand(card, shape, dtype, seed=17)
    want = hand.ring_halo_ref(z.clone(), axis=axis, n_bnd=n_bnd,
                              periodic=True)
    before = halo_routes()
    hand.ring_halo(z, axis=axis, n_bnd=n_bnd, periodic=True)
    torch.cuda.synchronize(card)
    assert halo_routes()[route] == before[route] + 1
    assert torch.equal(z, want)


@pytest.mark.parametrize("w", [2, 4])
@pytest.mark.parametrize("periodic", [True, False])
@pytest.mark.parametrize("dtype,axis,route,n_bnd,extent,other", [
    (torch.float32, 0, "vec16", 2, 40, 24),
    (torch.bfloat16, 1, "vec16", 8, 96, 37),
    (torch.float64, 1, "scalar", 3, 40, 45),
    (torch.float32, 0, "scalar", 3, 8, 45)])
def test_cross_wired_ring_halo_matches_the_plain_world(card, w, periodic,
                                                        dtype, axis, route,
                                                        n_bnd, extent,
                                                        other):
    """w ring-halo instances on one card, each with its own pad, stream
    and grid cap, their neighbours wired to each other's (distinct left
    and right at w = 4): bit for bit the plain world, on both routes and
    the staged extent."""
    shape = (extent, other) if axis == 0 else (other, extent)
    shards = [rand(card, shape, dtype, seed=100 + r) for r in range(w)]
    assert hand.halo_route(shards[0], axis, n_bnd, shards[1].data_ptr(),
                           shards[-1].data_ptr()) == route
    got = hand.cross_wired("ring_halo", shards, axis=axis, n_bnd=n_bnd,
                           periodic=periodic)
    want = hand.ring_halo_world_ref([s.cpu() for s in shards], axis=axis,
                                    n_bnd=n_bnd, periodic=periodic)
    for g, e in zip(got, want):
        assert torch.equal(g.cpu(), e)


def test_ring_halo_chain_across_routes_and_the_fused_kernel(card):
    """Chained launches on one pad that alternate the ring halo's two
    routes and the fused RDMA kernel (which counts its sends the old way
    on the same words): the epochs advance, the local words reset, every
    result bit for bit its plain version."""
    zs = {"vec16": rand(card, (40, 64), torch.float32, seed=41),
          "scalar": rand(card, (40, 45), torch.float32, seed=42)}
    want = {k: t.clone() for k, t in zs.items()}
    fz = rand(card, (40, 64), torch.float32, seed=43)
    before = halo_routes()
    for i in range(12):
        route = "vec16" if i % 2 else "scalar"
        hand.ring_halo(zs[route], axis=0, n_bnd=4, periodic=True)
        hand.ring_halo_ref(want[route], axis=0, n_bnd=4, periodic=True)
        got = hand.stencil2d_fused_rdma(fz, 0.01, steps=2, periodic=True,
                                        phys_static=(0, 0))
        assert torch.equal(got, hand.stencil2d_fused_rdma_ref(
            fz.clone(), 0.01, steps=2, periodic=True, phys_static=(0, 0)))
    torch.cuda.synchronize(card)
    for k in zs:
        assert torch.equal(zs[k], want[k])
    after = halo_routes()
    assert {r: after[r] - before[r] for r in after} == \
        {"vec16": 6, "scalar": 6}


def test_ring_halo_launch_refuses_another_route(card, monkeypatch):
    """The launcher checks the route it is given: a wrapper that named
    another route than the rule's gets an error, never a fallback."""
    z = rand(card, (40, 64), torch.float32, seed=1)
    monkeypatch.setattr(hand, "halo_route", lambda *a: "scalar")
    with pytest.raises(RuntimeError, match="scalar route"):
        hand.ring_halo(z, axis=0, n_bnd=2, periodic=True)
    monkeypatch.setattr(hand, "halo_route", lambda *a: "vec16")
    with pytest.raises(RuntimeError, match="vec16 route"):
        hand.ring_halo(rand(card, (40, 45), torch.float32, seed=2),
                       axis=0, n_bnd=2, periodic=True)
    with pytest.raises(RuntimeError, match="vec16 route"):
        hand.ring_halo(z[:5], axis=0, n_bnd=2, periodic=True)  # staged


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("steps", [1, 4])
@pytest.mark.parametrize("periodic", [True, False])
@pytest.mark.parametrize("rows,tile_rows", [(20, None), (40, None),
                                            (64, 32), (112, 16),
                                            (200, None)])
def test_fused_rdma_kernel_matches_chained_and_plain(card, dtype, steps,
                                                     periodic, rows,
                                                     tile_rows):
    """The fused launch against ring_halo -> stencil2d_iterate and
    against its plain version, bit for bit, over 21 chained calls."""
    K = 2 * steps
    if rows <= 2 * K:
        pytest.skip("height under the ghost width")
    z0 = rand(card, (rows, 150), dtype, seed=rows + steps)
    fused = TH.iterate_fused_rdma_fn(K, 0.01, steps=steps,
                                     periodic=periodic, tile_rows=tile_rows)
    chained = TH.iterate_hand_fn(K, 0.01, axis=0, steps=steps,
                                 periodic=periodic, rdma=True)
    before = hand.stencil2d_fused_rdma.launches
    a = fused(z0.clone(), 21)
    b = chained(z0.clone(), 21)
    torch.cuda.synchronize(card)
    assert hand.stencil2d_fused_rdma.launches == before + 21
    assert torch.equal(a, b)
    flags = {"phys_static": (0, 0) if periodic else (1, 1)}
    want = hand.stencil2d_fused_rdma_ref(z0.clone(), 0.01, steps=steps,
                                         periodic=periodic,
                                         tile_rows=tile_rows, **flags)
    got = hand.stencil2d_fused_rdma(z0.clone(), 0.01, steps=steps,
                                    periodic=periodic, tile_rows=tile_rows,
                                    **flags)
    torch.cuda.synchronize(card)
    assert torch.equal(got, want)


FLAG_CASES = [(0, 0), (1, 1), (1, 0), (0, 1), "dynamic"]


def kstep_operand(card, dtype, dim, steps, geometry, seed):
    """A k-step operand: ``aligned`` rows of whole 16-byte vectors ragged
    against the regs route's run, strip and segment
    (``chip_smoke.iterate_edges``), ``rows8`` the same 8 bytes wider
    (rows on 8 bytes, off 16), ``pitch`` one element wider, ``view`` the
    aligned shape one element past 16 bytes."""
    item = torch.empty((), dtype=dtype).element_size()
    shape = list(CS.iterate_edges(dtype, dim, steps)[1])
    shape[1] += {"rows8": 8 // item, "pitch": 1}.get(geometry, 0)
    n = shape[0] * shape[1]
    off = 1 if geometry == "view" else 0
    return rand(card, (n + off,), dtype, seed)[off:].view(shape)


def kstep_vec(dtype, geometry):
    """The regs route's vector bytes a :func:`kstep_operand` takes (0:
    none, the smem route)."""
    item = torch.empty((), dtype=dtype).element_size()
    return {"aligned": 16, "rows8": 8}.get(geometry, 8 if item == 8 else 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
@pytest.mark.parametrize("dim", [0, 1])
@pytest.mark.parametrize("steps", [*range(1, 10), 12])
@pytest.mark.parametrize("geometry", ["aligned", "rows8", "pitch", "view"])
def test_iterate_both_routes_match_plain(card, dtype, dim, steps, geometry):
    """Both routes bit for bit: regs at steps <= 8 on rows on 8 bytes
    (16-byte vectors where they are on 16), smem at 9 and 12 steps and on
    rows or a view off 8 bytes; every static flag pair and the dynamic
    flags, each launch counted on the route the rule names."""
    z = kstep_operand(card, dtype, dim, steps, geometry, seed=steps + dim)
    route = hand.kstep_route(z, dim, steps)
    vec = kstep_vec(dtype, geometry)
    assert hand.kstep_vec_bytes(z) == vec
    assert route == ("regs" if steps <= 8 and vec else "smem")
    for flags in FLAG_CASES:
        kw = ({"phys": torch.tensor([0, 1], dtype=torch.int32, device=card)}
              if flags == "dynamic" else {"phys_static": flags})
        before = dict(hand.stencil2d_iterate.launches_by_route)
        got = hand.stencil2d_iterate(z, 0.37, dim=dim, steps=steps, **kw)
        want = hand.stencil2d_iterate_ref(z, 0.37, dim=dim, steps=steps,
                                          **kw)
        torch.cuda.synchronize(card)
        assert torch.equal(got, want), flags
        after = hand.stencil2d_iterate.launches_by_route
        assert {r: after[r] - before[r] for r in after} == {
            r: int(r == route) for r in hand.KSTEP_ROUTES}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("steps", [1, 4, 8, 9])
@pytest.mark.parametrize("geometry", ["aligned", "rows8", "pitch"])
@pytest.mark.parametrize("periodic", [True, False])
def test_fused_rdma_both_routes_match_chained_and_plain(
        card, dtype, steps, geometry, periodic):
    """The fused kernel on both routes (regs on rows of whole 16-byte
    vectors up to 8 steps; smem otherwise, rows on 8 bytes among them)
    against the chained tier over 21 calls and against its plain version,
    bit for bit, each launch on its route, its row block the
    launcher's."""
    K = 2 * steps
    item = torch.empty((), dtype=dtype).element_size()
    width = 16 // item * 19 + {"aligned": 0, "rows8": 8 // item,
                               "pitch": 1}[geometry]
    z0 = rand(card, (10 * K, width), dtype, seed=steps)
    route = hand.kstep_route(z0, 0, steps, fused=True)
    assert hand.kstep_vec_bytes(z0) == kstep_vec(dtype, geometry)
    assert route == ("regs" if geometry == "aligned" and steps <= 8
                     else "smem")
    fused = TH.iterate_fused_rdma_fn(K, 0.01, steps=steps,
                                     periodic=periodic)
    chained = TH.iterate_hand_fn(K, 0.01, axis=0, steps=steps,
                                 periodic=periodic, rdma=True)
    before = dict(hand.stencil2d_fused_rdma.launches_by_route)
    a = fused(z0.clone(), 21)
    b = chained(z0.clone(), 21)
    torch.cuda.synchronize(card)
    after = hand.stencil2d_fused_rdma.launches_by_route
    assert {r: after[r] - before[r] for r in after} == {
        r: 21 * int(r == route) for r in hand.KSTEP_ROUTES}
    B = hand.stencil2d_fused_rdma.block_rows
    assert B >= 2 * K and (10 * K) % B == 0
    assert B == hand.fused_block_rows(10 * K, steps, None, route) or (
        route == "regs")
    assert torch.equal(a, b)
    flags = {"phys_static": (0, 0) if periodic else (1, 1)}
    got = hand.stencil2d_fused_rdma(z0.clone(), 0.01, steps=steps,
                                    periodic=periodic, **flags)
    want = hand.stencil2d_fused_rdma_ref(z0.clone(), 0.01, steps=steps,
                                         periodic=periodic, **flags)
    torch.cuda.synchronize(card)
    assert torch.equal(got, want)


@pytest.mark.parametrize("w", [2, 4])
@pytest.mark.parametrize("periodic", [True, False])
@pytest.mark.parametrize("dtype,shape,steps", [
    (torch.float32, (40, 96), 2),     # vec16 sends, regs body
    (torch.float32, (40, 98), 2),     # scalar sends, smem body (8 bytes)
    (torch.bfloat16, (40, 45), 2),    # scalar sends, smem body
    (torch.float32, (10, 96), 2),     # staged sends (height under 3K)
    (torch.float64, (60, 40), 9)])    # vec16 sends, smem body (9 steps)
def test_fused_rdma_cross_wired(card, w, periodic, dtype, shape, steps):
    """w instances of the fused kernel on one card, their peer pointers
    cross-wired, against the plain world bit for bit."""
    shards = [rand(card, shape, dtype, seed=r) for r in range(w)]
    kw = {"scale_eps": 0.01, "steps": steps, "periodic": periodic}
    got = hand.cross_wired("stencil2d_fused_rdma", shards, **kw)
    want = hand.stencil2d_fused_rdma_world_ref([t.cpu() for t in shards],
                                               **kw)
    for g, e in zip(got, want):
        assert torch.equal(g.cpu(), e)


def test_kstep_launch_refuses_another_route(card, monkeypatch):
    """The launchers check the route they are given: a wrapper that named
    another route than the rule's gets an error, never a fallback."""
    z = rand(card, (64, 128), torch.float32, seed=3)
    odd = rand(card, (64, 129), torch.float32, seed=4)
    monkeypatch.setattr(hand, "kstep_route", lambda *a, **k: "smem")
    with pytest.raises(RuntimeError, match="smem route"):
        hand.stencil2d_iterate(z, 0.1, dim=0, steps=2)
    with pytest.raises(RuntimeError, match="smem route"):
        hand.stencil2d_fused_rdma(z, 0.1, steps=2, local_only=True)
    monkeypatch.setattr(hand, "kstep_route", lambda *a, **k: "regs")
    with pytest.raises(RuntimeError, match="regs route"):
        hand.stencil2d_iterate(odd, 0.1, dim=1, steps=2)
    with pytest.raises(RuntimeError, match="regs route"):
        hand.stencil2d_iterate(z, 0.1, dim=1, steps=9)
    with pytest.raises(RuntimeError, match="regs route"):
        hand.stencil2d_fused_rdma(odd, 0.1, steps=2, local_only=True)


def test_fused_rdma_local_only_is_the_iterate_kernel(card):
    z = rand(card, (64, 200), torch.float32, seed=9)
    got = hand.stencil2d_fused_rdma(z, 0.01, steps=2, local_only=True,
                                    phys_static=(1, 1))
    want = hand.stencil2d_iterate(z, 0.01, dim=0, steps=2,
                                  phys_static=(1, 1))
    torch.cuda.synchronize(card)
    assert torch.equal(got, want)


def test_rdma_tiers_and_staging_on_card(card, capsys):
    from tpu_mpi_tests_torch.drivers import stencil2d

    rc = stencil2d.main(["--n-local", "64", "--n-other", "256", "--n-iter",
                         "3", "--n-warmup", "1", "--rdma", "--iterate-tier",
                         "rdma-fused", "--iterate-steps", "2"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "ITER BITWISE fused==chained over 4 calls: OK" in out
    assert "OVERLAP stencil2d_fused_rdma overlap_frac=" in out
    assert out.count("TEST dim:") == 6


def test_two_ranks_cannot_share_one_card(card, tmp_path):
    """Two ranks on one card (a gloo world, both on card 0): torch's
    symmetric-memory rendezvous refuses overlapping devices, and the peer
    layer raises instead of falling back."""
    W.spawn("symm_one_card", 2, tmp_path)
    for r in range(2):
        got = W.read_text(str(tmp_path), "symm", r)
        assert got.startswith("PeerError: symmetric-memory rendezvous"), got
        assert "overlapping devices" in got, got


# ---------------------------------------------------------------------------
# the collective kernels: ring all-gather, ring reduce-scatter, one-shot
# ---------------------------------------------------------------------------

COLL_DTYPES = [torch.float32, torch.bfloat16, torch.float64]


def coll_shape(kind, k):
    """A shard no TPU tile admits: 1001·k rows (elements of a 1-D one)."""
    return (1001 * k,) if kind == "1d" else (1001 * k, 3)


@pytest.mark.parametrize("dtype", COLL_DTYPES)
@pytest.mark.parametrize("kind", ["1d", "2d"])
@pytest.mark.parametrize("k", [None, 2, 4, 8])
def test_ring_allgather_kernel_matches_plain(card, dtype, kind, k):
    x = rand(card, coll_shape(kind, k or 1), dtype, seed=3 + (k or 1))
    before = hand.ring_allgather.launches
    got = hand.ring_allgather(x, self_ring=k)
    torch.cuda.synchronize(card)
    assert hand.ring_allgather.launches == before + 1
    assert torch.equal(got, hand.ring_allgather_ref(x, self_ring=k))
    assert torch.equal(got, x.repeat((k or 1,) + (1,) * (x.dim() - 1)))


@pytest.mark.parametrize("dtype", COLL_DTYPES)
@pytest.mark.parametrize("kind", ["1d", "2d"])
@pytest.mark.parametrize("k", [None, 2, 4, 8])
@pytest.mark.parametrize("credits", [1, 2])
def test_ring_reduce_scatter_kernel_matches_plain(card, dtype, kind, k,
                                                  credits):
    x = rand(card, coll_shape(kind, k or 1), dtype, seed=5 + (k or 1))
    before = hand.ring_reduce_scatter.launches
    got = hand.ring_reduce_scatter(x, credits=credits, self_ring=k)
    torch.cuda.synchronize(card)
    assert hand.ring_reduce_scatter.launches == before + 1
    assert torch.equal(got, hand.ring_reduce_scatter_ref(
        x, credits=credits, self_ring=k))


@pytest.mark.parametrize("dtype", COLL_DTYPES)
@pytest.mark.parametrize("shape", [(7,), (4096,), (33, 5)])
@pytest.mark.parametrize("op", ["gather", "sum"])
def test_oneshot_kernel_matches_plain(card, dtype, shape, op):
    x = rand(card, shape, dtype, seed=len(shape) + shape[0])
    before = hand.oneshot.launches
    got = hand.oneshot(x, op)
    torch.cuda.synchronize(card)
    assert hand.oneshot.launches == before + 1
    assert torch.equal(got, hand.oneshot_ref(x, op))
    assert torch.equal(got, x)


def oneshot_routes():
    return dict(hand.oneshot.launches_by_route)


@pytest.mark.parametrize("route,n,off", [("vec16", 4096, 0),
                                         ("vec16", 1 << 20, 0),
                                         ("scalar", 4095, 0),
                                         ("scalar", 4096, 1)])
@pytest.mark.parametrize("dtype", COLL_DTYPES)
@pytest.mark.parametrize("op", ["gather", "sum"])
def test_oneshot_route_matches_plain(card, route, n, off, dtype, op):
    """World 1 on each route: whole 16-byte vectors, an odd length and a
    view off 16 bytes; bit for bit the plain version (a copy), one launch
    counted on the route."""
    base = rand(card, (n + off,), dtype, seed=n + off)
    x = base[off:]
    before = oneshot_routes()
    got = hand.oneshot(x, op)
    torch.cuda.synchronize(card)
    after = oneshot_routes()
    assert {r: after[r] - before[r] for r in after} == \
        {r: int(r == route) for r in after}
    assert torch.equal(got, hand.oneshot_ref(x, op))


@pytest.mark.parametrize("name", ["oneshot_allgather", "oneshot_allreduce"])
@pytest.mark.parametrize("w", [2, 4, 8])
@pytest.mark.parametrize("dtype", COLL_DTYPES)
@pytest.mark.parametrize("route", ["vec16", "scalar"])
def test_cross_wired_oneshot_routes_match_the_plain_world(card, name, w,
                                                          dtype, route):
    """w one-shot instances on one card, cross-wired, on shards of 1024
    rows (vec16) and 1001 rows (scalar): the fold in ascending rank and
    the gather bit for bit the plain world."""
    rows = 1024 if route == "vec16" else 1001
    shards = [rand(card, (rows, 3), dtype, seed=120 + r) for r in range(w)]
    assert hand.coll_route(shards[0], shards[0].numel()) == route
    got = hand.cross_wired(name, shards)
    want = hand.coll_world_ref(name, [s.cpu() for s in shards])
    for g, e in zip(got, want):
        assert torch.equal(g.cpu(), e)


def test_oneshot_launch_refuses_another_route(card, monkeypatch):
    x = rand(card, (4096,), torch.float32, seed=1)
    monkeypatch.setattr(hand, "coll_route", lambda *a: "scalar")
    with pytest.raises(RuntimeError, match="scalar route"):
        hand.oneshot(x, "sum")
    monkeypatch.setattr(hand, "coll_route", lambda *a: "vec16")
    with pytest.raises(RuntimeError, match="vec16 route"):
        hand.oneshot(x[1:], "gather")


def test_ring_collectives_chain_on_the_card(card):
    """Chained launches on one pad (the epochs advance, the local words
    reset): 20 alternating self-ring reduce-scatters and all-gathers."""
    x = rand(card, (4 * 1001, 2), torch.float32, seed=11)
    for i in range(20):
        got = hand.ring_reduce_scatter(x, credits=1 + i % 2, self_ring=4)
        again = hand.ring_allgather(got, self_ring=4)
    torch.cuda.synchronize(card)
    want = hand.ring_reduce_scatter_ref(x, self_ring=4)
    assert torch.equal(got, want)
    assert torch.equal(again, want.repeat(4, 1))


def test_ring_allreduce_at_world1_is_one_copy(card):
    x = rand(card, (1001,), torch.bfloat16, seed=13)
    before = hand.launch_counts()
    got = hand.ring_allreduce(x, credits=2)
    torch.cuda.synchronize(card)
    assert torch.equal(got, x)
    after = hand.launch_counts()
    assert after["ring_reduce_scatter"] == before["ring_reduce_scatter"] + 1
    assert after["ring_allgather"] == before["ring_allgather"]


def test_collectives_refuse_bad_worlds_on_card(card):
    from tpu_mpi_tests_torch.comm.peer import PeerError

    x = rand(card, (40,), torch.float32, seed=1)
    with pytest.raises(PeerError, match="at most 8"):
        hand.ring_allgather(x, self_ring=9)
    with pytest.raises(PeerError, match="at most 8"):
        hand.cross_wired("ring_allgather", [x] * 9)
    with pytest.raises(ValueError, match="elements % w == 0"):
        hand.ring_reduce_scatter(x, self_ring=3)
    with pytest.raises(ValueError, match="elements % w == 0"):
        hand.cross_wired("ring_reduce_scatter", [x[:39]] * 2)


@pytest.mark.parametrize("name", ["ring_allgather", "ring_reduce_scatter",
                                  "oneshot_allgather", "oneshot_allreduce"])
@pytest.mark.parametrize("w", [2, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("credits", [1, 2])
def test_cross_wired_instances_match_the_plain_world(card, name, w, dtype,
                                                     credits):
    """w instances of a kernel in one process, cross-wired, each on its
    own stream: the w > 1 data path and signalling, held bit for bit
    against the plain versions' world (computed on the CPU)."""
    if credits == 2 and name != "ring_reduce_scatter":
        pytest.skip("credits apply to the reduce-scatter only")
    shards = [rand(card, (w * 1001, 3), dtype, seed=20 + r)
              for r in range(w)]
    got = hand.cross_wired(name, shards, credits=credits)
    want = hand.coll_world_ref(name, [s.cpu() for s in shards])
    for g, e in zip(got, want):
        assert torch.equal(g.cpu(), e)


# ---------------------------------------------------------------------------
# the ring collectives' two routes: vec16 (16-byte vectors) and scalar
# ---------------------------------------------------------------------------


def coll_routes(name):
    return dict(getattr(hand, name).launches_by_route)


def route_shard(card, kernel, route, kind, k, dtype, seed):
    """A shard of ``kernel`` whose launch takes ``route``: 1024-row
    regions (chunks) are whole 16-byte vectors in every dtype; the
    all-gather's 1001-row shard and the reduce-scatter's 1001-row chunks
    are not, in any dtype."""
    rows = 1024 if route == "vec16" else 1001
    if kernel == "ring_reduce_scatter":
        rows *= k or 1
    shape = (rows,) if kind == "1d" else (rows, 3)
    return rand(card, shape, dtype, seed)


def check_route(name, before, route):
    after = coll_routes(name)
    assert {r: after[r] - before[r] for r in after} == \
        {r: int(r == route) for r in after}


@pytest.mark.parametrize("route", ["vec16", "scalar"])
@pytest.mark.parametrize("dtype", COLL_DTYPES)
@pytest.mark.parametrize("kind", ["1d", "2d"])
@pytest.mark.parametrize("k", [None, 2, 4, 8])
def test_ring_allgather_route_matches_plain(card, route, dtype, kind, k):
    """World 1 (one copy) and the self-ring k = 2, 4, 8 on each route:
    bit for bit the plain version, one launch counted on the route."""
    x = route_shard(card, "ring_allgather", route, kind, k, dtype,
                    40 + (k or 1))
    assert hand.coll_route(x, x.numel()) == route
    before = coll_routes("ring_allgather")
    got = hand.ring_allgather(x, self_ring=k)
    torch.cuda.synchronize(card)
    check_route("ring_allgather", before, route)
    assert torch.equal(got, hand.ring_allgather_ref(x, self_ring=k))


@pytest.mark.parametrize("route", ["vec16", "scalar"])
@pytest.mark.parametrize("dtype", COLL_DTYPES)
@pytest.mark.parametrize("kind", ["1d", "2d"])
@pytest.mark.parametrize("k", [None, 2, 4, 8])
@pytest.mark.parametrize("credits", [1, 2])
def test_ring_reduce_scatter_route_matches_plain(card, route, dtype, kind, k,
                                                 credits):
    """World 1 and the self-ring k = 2, 4, 8 at credits 1 (the send
    buffer) and 2 (the one-pass fold) on each route: the float32,
    float64 and per-op-rounded bfloat16 folds bit for bit the plain
    version, one launch counted on the route."""
    x = route_shard(card, "ring_reduce_scatter", route, kind, k, dtype,
                    50 + (k or 1))
    assert hand.coll_route(x, x.numel() // (k or 1)) == route
    before = coll_routes("ring_reduce_scatter")
    got = hand.ring_reduce_scatter(x, credits=credits, self_ring=k)
    torch.cuda.synchronize(card)
    check_route("ring_reduce_scatter", before, route)
    assert torch.equal(got, hand.ring_reduce_scatter_ref(
        x, credits=credits, self_ring=k))


@pytest.mark.parametrize("name", ["ring_allgather", "ring_reduce_scatter"])
@pytest.mark.parametrize("off", [1, 2, 3])
def test_misaligned_shard_takes_the_scalar_route(card, name, off):
    """A shard that starts off 16 bytes (a contiguous view) takes the
    scalar route, whatever its length."""
    base = rand(card, (4 * 1024 + 4,), torch.float32, seed=60 + off)
    x = base[off:off + 4 * 1024]
    kw = {"self_ring": 4}
    before = coll_routes(name)
    got = getattr(hand, name)(x, **kw)
    torch.cuda.synchronize(card)
    check_route(name, before, "scalar")
    assert torch.equal(got, getattr(hand, f"{name}_ref")(x, **kw))


@pytest.mark.parametrize("name,n,dtype", [
    ("ring_reduce_scatter", 524288, torch.float32),
    ("ring_allgather", 4194304, torch.float32),
    ("ring_reduce_scatter", 4194304, torch.float32),
    ("ring_allgather", 1 << 24, torch.float64)])
def test_main_path_sizes_take_vec16(card, name, n, dtype):
    """The main paths' world=1 operands (stencil2d --rdma's 2 MiB row,
    collbench's 16 MiB shard, a 128 MiB float64 shard of
    gather_inplace's kind) take vec16 and copy bit for bit."""
    x = rand(card, (n,), dtype, seed=70)
    before = coll_routes(name)
    got = getattr(hand, name)(x)
    torch.cuda.synchronize(card)
    check_route(name, before, "vec16")
    assert torch.equal(got, x)


@pytest.mark.parametrize("name", ["ring_allgather", "ring_reduce_scatter"])
@pytest.mark.parametrize("w", [2, 4])
@pytest.mark.parametrize("dtype", COLL_DTYPES)
@pytest.mark.parametrize("credits", [1, 2])
def test_cross_wired_vec16_instances_match_the_plain_world(card, name, w,
                                                           dtype, credits):
    """w instances cross-wired on one card, on shards of 1024·w rows
    (whole 16-byte vectors: the vec16 route), held bit for bit against
    the plain versions' world."""
    if credits == 2 and name != "ring_reduce_scatter":
        pytest.skip("credits apply to the reduce-scatter only")
    shards = [rand(card, (w * 1024, 3), dtype, seed=80 + r)
              for r in range(w)]
    n = shards[0].numel() // (w if name == "ring_reduce_scatter" else 1)
    assert hand.coll_route(shards[0], n) == "vec16"
    got = hand.cross_wired(name, shards, credits=credits)
    want = hand.coll_world_ref(name, [s.cpu() for s in shards])
    for g, e in zip(got, want):
        assert torch.equal(g.cpu(), e)


def test_ring_collectives_chain_across_routes_on_the_card(card):
    """Chained launches on one pad that alternate the two kernels, both
    credits and both routes: 24 reduce-scatters and all-gathers on the
    self-ring k = 4, the epochs advancing and the local words reset."""
    xs = {"vec16": rand(card, (4 * 1024, 2), torch.float32, seed=90),
          "scalar": rand(card, (4 * 1001, 2), torch.float32, seed=91)}
    before = {n: coll_routes(n) for n in ("ring_allgather",
                                          "ring_reduce_scatter")}
    got = {}
    for i in range(24):
        route = "vec16" if i % 4 < 2 else "scalar"
        rs = hand.ring_reduce_scatter(xs[route], credits=1 + i % 2,
                                      self_ring=4)
        got[route, 1 + i % 2] = (rs, hand.ring_allgather(rs, self_ring=4))
    torch.cuda.synchronize(card)
    for (route, credits), (rs, ag) in got.items():
        want = hand.ring_reduce_scatter_ref(xs[route], credits, self_ring=4)
        assert torch.equal(rs, want)
        assert torch.equal(ag, want.repeat(4, 1))
    for n in before:
        after = coll_routes(n)
        assert {r: after[r] - before[n][r] for r in after} == \
            {"vec16": 12, "scalar": 12}


def test_collective_launch_refuses_another_route(card, monkeypatch):
    """The launcher checks the route it is given: a wrapper that named
    another route than the rule's gets an error, never a fallback."""
    x = rand(card, (4096,), torch.float32, seed=1)
    monkeypatch.setattr(hand, "coll_route", lambda *a: "scalar")
    with pytest.raises(RuntimeError, match="scalar route"):
        hand.ring_allgather(x)
    with pytest.raises(RuntimeError, match="scalar route"):
        hand.ring_reduce_scatter(x, self_ring=2)
    monkeypatch.setattr(hand, "coll_route", lambda *a: "vec16")
    with pytest.raises(RuntimeError, match="vec16 route"):
        hand.ring_allgather(x[1:])
    with pytest.raises(RuntimeError, match="vec16 route"):
        hand.ring_reduce_scatter(x[:4002], self_ring=2)


def test_collective_drivers_on_card(card, capsys):
    from tpu_mpi_tests_torch.drivers import collbench

    names = ",".join(collbench.COLLECTIVES + collbench.COLLECTIVES_RDMA
                     + collbench.COLLECTIVES_ONESHOT)
    before = hand.launch_counts()
    assert collbench.main(["--collectives", names, "--sizes-kib", "1024",
                           "--n-iter", "10"]) == 0
    out = capsys.readouterr().out
    assert out.count("COLL ") == 9 and "nan" not in out
    after = hand.launch_counts()
    assert after["oneshot"] > before["oneshot"]
    assert after["ring_allgather"] > before["ring_allgather"]
    assert after["ring_reduce_scatter"] > before["ring_reduce_scatter"]
    assert gather_inplace.main(["--n-per-rank", "4096", "--rdma"]) == 0
    assert capsys.readouterr().out == "0/1 lsum=4096.0 asum=4096.0\n"


# ---------------------------------------------------------------------------
# the fused ring attention: every ring step in one launch
# ---------------------------------------------------------------------------

FUSED_LAYOUTS = [(False, False), (True, False), (True, True)]


def fused_tolerance(dtype, precision, want):
    """Kernel vs plain: f32 arithmetic (HIGHEST) to 1e-5, the tensor cores
    (DEFAULT) to FLASH_DEFAULT_ATOL of the plain version at HIGHEST; a
    bf16 output adds its own rounding (one ulp, 2^-8 relative)."""
    tol = 1e-5 if precision == "highest" else FLASH_DEFAULT_ATOL[dtype]
    if dtype == torch.bfloat16:
        tol += 2.0**-8 * want.float().abs().max().item()
    return tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("causal,stripe", FUSED_LAYOUTS)
@pytest.mark.parametrize("k", [None, 2, 4, 8])
@pytest.mark.parametrize("L,d", [(7, 17), (200, 64), (130, 256)])
def test_fused_ring_kernel_matches_plain_and_pipelined(card, dtype, precision,
                                                       causal, stripe, k, L,
                                                       d):
    """At world=1 (one step) and on the self-ring (k steps into the rank's
    own slots): bit for bit the pipelined tier's flash launches, and the
    plain version within the flash kernel's tolerances."""
    q, kk, v = (rand(card, (L, d), dtype, s) for s in (1, 2, 3))
    kw = dict(causal=causal, stripe=stripe, precision=precision)
    before = hand.fused_ring_attention.launches
    got = hand.fused_ring_attention(q, kk, v, self_ring=k, **kw)
    torch.cuda.synchronize(card)
    assert hand.fused_ring_attention.launches == before + 1
    w = k or 1
    flash = hand.fused_ring_world_ref([(q, kk, v)] * w, kernel=True, **kw)[0]
    assert torch.equal(got, flash)
    want = hand.fused_ring_attention_ref(q, kk, v, self_ring=k, causal=causal,
                                         stripe=stripe)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= fused_tolerance(dtype, precision, want), err


@pytest.mark.parametrize("w", [2, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("causal,stripe", FUSED_LAYOUTS)
def test_fused_ring_cross_wired_instances(card, w, dtype, precision, causal,
                                          stripe):
    """w instances cross-wired on one card (the w > 1 data path, credits
    and flags): each rank's output bit for bit the pipelined tier's flash
    launches over the ranks' blocks, and the plain world within the
    flash kernel's tolerances."""
    blocks = [tuple(rand(card, (200, 64), dtype, 10 * r + s)
                    for s in (1, 2, 3)) for r in range(w)]
    kw = dict(causal=causal, stripe=stripe, precision=precision)
    got = hand.cross_wired("fused_ring_attention", blocks, **kw)
    flash = hand.fused_ring_world_ref(blocks, kernel=True, **kw)
    plain = hand.fused_ring_world_ref(blocks, causal=causal, stripe=stripe)
    for g, f, p in zip(got, flash, plain):
        assert torch.equal(g, f)
        err = (g.float() - p.float()).abs().max().item()
        assert err <= fused_tolerance(dtype, precision, p), err


def test_fused_ring_chain_shares_the_pad(card):
    """Chained launches on one pad, interleaved with a collective (the
    epochs advance across kernel families, the local words reset): the
    128-word pad ends with the fused kernel's local counters at 0."""
    from tpu_mpi_tests_torch.comm.peer import PAD_WORDS, peer_ring

    q, kk, v = (rand(card, (300, 128), torch.float32, s) for s in (1, 2, 3))
    x = rand(card, (4 * 1001,), torch.float32, seed=4)
    ks = [2 + i % 7 for i in range(12)]  # 2..8, then 2..6
    for k in ks:
        got = hand.fused_ring_attention(q, kk, v, causal=True, stripe=True,
                                        self_ring=k)
        hand.ring_allgather(x, self_ring=4)
    torch.cuda.synchronize(card)
    want = hand.fused_ring_world_ref([(q, kk, v)] * ks[-1], causal=True,
                                     stripe=True, kernel=True)[0]
    assert torch.equal(got, want)
    pad = peer_ring(card).pad
    assert pad.numel() == PAD_WORDS == 128
    assert int(pad[82:99].abs().sum()) == 0  # kFraSent..kFraExit


def test_fused_ring_refusals_on_card(card):
    from tpu_mpi_tests_torch.comm.peer import PeerError

    q = rand(card, (64, 32), torch.float32, seed=1)
    with pytest.raises(PeerError, match="at most 8"):
        hand.fused_ring_attention(q, q, q, self_ring=9)
    with pytest.raises(ValueError, match="stripe=True only"):
        hand.fused_ring_attention(q, q, q, stripe=True)
    with pytest.raises(ValueError, match="contiguous"):
        hand.fused_ring_attention(q.T.contiguous().T, q, q)
    with pytest.raises(PeerError, match="at most 8"):
        hand.cross_wired("fused_ring_attention", [(q, q, q)] * 9)


def test_attnbench_fused_tier_on_card(card, capsys):
    from tpu_mpi_tests_torch.drivers import attnbench

    before = hand.launch_counts()
    assert attnbench.main(["--seq-len", "1024", "--head-dim", "64",
                           "--tiers", "ring", "--ring-tier", "fused",
                           "--causal", "--stripe", "--n-iter", "10"]) == 0
    out = capsys.readouterr().out
    assert "ATTN ring[striped][fused] L=1024 d=64 float32 " in out
    after = hand.launch_counts()
    # chain_rate: 3 warm calls, then 1 and 10: one launch per call
    assert after["fused_ring_attention"] - \
        before["fused_ring_attention"] == 14
    assert after["flash_attention_block"] == before["flash_attention_block"]


# ---------------------------------------------------------------------------
# the overlap engine: depth 2's exchange on the runner's comm stream
# ---------------------------------------------------------------------------

PIPE_SHAPES = {"jacobi": (4100,), "heat": (130, 98), "grid": (132, 100)}


def overlap_pipeline(name, z, depth, core_wrap=None, exchange_wrap=None):
    """A split pipeline at ``depth`` (4 rounds, or one grid step), with
    its core or exchange optionally wrapped; returns (result, runner)."""
    if name == "jacobi":
        fns = TH.overlap_jacobi_fns(0, 2, 3.0, 1e-2, periodic=True)
    elif name == "heat":
        fns = TH.heat_overlap_fns(0.1, 0.2)
    else:
        fns = TH.grid_overlap_fns(2, 1.5, 0.75)
    ex_fn, core, seam = fns
    ex_fn = exchange_wrap(ex_fn) if exchange_wrap else ex_fn
    core = core_wrap(core) if core_wrap else core
    runner = TH.OverlapRunner("halo_exchange", depth=depth)
    if name == "grid":
        ex, cores = runner.step(ex_fn, core, z)
        out = seam(ex, *cores)
    else:
        out = TH.overlap_steps(runner, (ex_fn, core, seam), z, 4)
    torch.cuda.synchronize()
    return out, runner


def as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", list(PIPE_SHAPES))
def test_overlap_pipelines_depth2_equals_depth1_on_card(card, name, dtype):
    z = rand(card, PIPE_SHAPES[name], dtype, seed=11)
    d1, r1 = overlap_pipeline(name, z.clone(), 1)
    d2, r2 = overlap_pipeline(name, z.clone(), 2)
    plain, _ = overlap_pipeline(name, z.cpu(), 1)
    for a, b, c in zip(as_tuple(d1), as_tuple(d2), as_tuple(plain)):
        assert a.device == card and torch.equal(a, b)
        assert torch.equal(a.cpu(), c)
    assert r1.comm_stream is None and r1.streamed_steps == 0
    assert r2.comm_stream is not None
    assert r2.streamed_steps == r2.steps == (1 if name == "grid" else 4)


def sleeping(fn, cycles=2_000_000):
    """``fn`` after a spin kernel on the current stream (~1 ms)."""
    def run(*args, **kwargs):
        torch.cuda._sleep(cycles)
        return fn(*args, **kwargs)
    return run


@pytest.mark.parametrize("where", ["core", "exchange"])
@pytest.mark.parametrize("name", list(PIPE_SHAPES))
def test_exchange_in_flight_beside_a_long_kernel(card, name, where):
    """The exchange posted while a long kernel occupies the compute
    stream (the core starts with a spin kernel), and the core finishing
    while the exchange is still held on its stream (the exchange starts
    with one): the seam must see the arrived ghosts either way."""
    z = rand(card, PIPE_SHAPES[name], torch.float32, seed=12)
    wrap = {f"{where}_wrap": sleeping}
    got, runner = overlap_pipeline(name, z.clone(), 2, **wrap)
    want, _ = overlap_pipeline(name, z.clone(), 1)
    for a, b in zip(as_tuple(got), as_tuple(want)):
        assert torch.equal(a, b)
    if where == "exchange":  # the drain waited for the held exchange
        assert runner.drain_s > 0.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("periodic", [False, True])
def test_iterate_overlap_equals_iterate_hand_on_card(card, dtype, periodic):
    z = rand(card, (96, 260), dtype, seed=13)
    before = hand.route_counts()["stencil2d_iterate"]["regs"]
    got = TH.iterate_overlap_fn(2, 0.05, axis=1, periodic=periodic)(
        z.clone(), 7)
    torch.cuda.synchronize()
    assert hand.route_counts()["stencil2d_iterate"]["regs"] == before + 7
    want = TH.iterate_hand_fn(2, 0.05, axis=1, periodic=periodic)(
        z.clone(), 7)
    assert torch.equal(got, want)


def test_bench_overlap_schedule_on_card(card, monkeypatch, capsys):
    for var in [v for v in __import__("os").environ
                if v.startswith("TPU_MPI_BENCH_")]:
        monkeypatch.delenv(var)
    for var, val in (("N", "256"), ("OVERLAP", "2"), ("STEPS", "1"),
                     ("SECOND_DTYPE", "none"), ("ITERS_SHORT", "4"),
                     ("ITERS_LONG", "24"), ("SAMPLES", "1")):
        monkeypatch.setenv(f"TPU_MPI_BENCH_{var}", val)
    from tpu_mpi_tests_torch import bench

    rec = bench.main(["--device", "cuda"])
    assert rec["schedule"] == "dim1_world1_float32_ov2_blocks_h1x1"
    assert "NOTE" not in capsys.readouterr().err
    monkeypatch.setenv("TPU_MPI_BENCH_STEPS", "4")
    rec = bench.main(["--device", "cuda"])
    assert "_ov1_" in rec["schedule"]
    assert "NOTE overlap depth 2 not applicable" in capsys.readouterr().err


def test_tune_fingerprint_on_card(card):
    from tpu_mpi_tests_torch.tune import fingerprint as tfp

    fields = dict(tfp.device_fields())
    assert fields["platform"] == "gpu" and fields["stack"] == "torch"
    assert fields["device"] == torch.cuda.get_device_name(0).replace(
        ";", ",")
    assert fields["ndev"] == fields["procs"] == "1"


def test_stencil2d_tier_tune_then_hit_on_card(card, capsys, tmp_path,
                                              monkeypatch):
    """``--iterate-tier auto --tune`` measures every tier on the card (each
    a chain timed by CUDA events), stores the winner, and a rerun on the
    cache sweeps nothing and runs it to the same field."""
    monkeypatch.delenv("TPU_MPI_TUNE_CACHE", raising=False)
    from tpu_mpi_tests_torch.drivers import stencil2d

    cache = tmp_path / "tune.json"
    argv = ["--n-local", "256", "--n-other", "1024", "--iterate-steps", "4",
            "--iterate-iters", "3", "--iterate-only", "--iterate-tier",
            "auto", "--tune-cache", str(cache)]
    assert stencil2d.main(argv + ["--tune"]) == 0
    swept = capsys.readouterr().out
    assert "measured=4 skipped=0" in swept and "FAIL" not in swept
    assert cache.exists()
    hand.reset_launch_counts()
    assert stencil2d.main(argv) == 0
    hit = capsys.readouterr().out
    assert "TUNE stencil/tier cache-hit" in hit and "winner=" not in hit
    tier = W.tune_winner(swept)
    assert W.tune_winner(hit) == tier
    rel = [ln for ln in swept.splitlines() if ln.startswith("ITER ERR")]
    assert rel == [ln for ln in hit.splitlines()
                   if ln.startswith("ITER ERR")]


def test_bench_tune_on_card(card, monkeypatch, capsys, tmp_path):
    for var in [v for v in __import__("os").environ
                if v.startswith("TPU_MPI_BENCH_")]:
        monkeypatch.delenv(var)
    for var, val in (("N", "512"), ("SECOND_DTYPE", "none"),
                     ("ITERS_SHORT", "8"), ("ITERS_LONG", "64"),
                     ("SAMPLES", "1"), ("TUNE", "1")):
        monkeypatch.setenv(f"TPU_MPI_BENCH_{var}", val)
    monkeypatch.setenv("TPU_MPI_TUNE_CACHE", str(tmp_path / "tune.json"))
    from tpu_mpi_tests_torch import bench

    rec = bench.main(["--device", "cuda"])
    err = capsys.readouterr().err
    assert "(sweep)" in err and rec["value"] > 0
    monkeypatch.delenv("TPU_MPI_BENCH_TUNE")
    rec2 = bench.main(["--device", "cuda"])
    err = capsys.readouterr().err
    assert "(cache)" in err and rec2["schedule"] == rec["schedule"]


# ---------------------------------------------------------------------------
# chained rows as CUDA graph replays (instrument/timers.chain_rate) and
# the RDMA kernels' epochs from the pad's launch counter
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tier", ["blocks", "rdma-chained", "rdma-fused"])
def test_bench_graph_chain_equals_eager(card, tier):
    """A bench run's chain as graph replays ends where the eager chain
    ends, bit for bit (chip_smoke.chain_both raises otherwise)."""
    from tpu_mpi_tests_torch import bench

    run, state, _, _ = bench.build_schedule("float32", n=512, steps=4,
                                            n_blocks=2, tier=tier,
                                            device=card)
    got = CS.chain_both(f"bench {tier}", run, state, 3, 17, repeats=2)
    assert got["eager_s"] > 0 and got["graph_s"] > 0


@pytest.mark.parametrize("fused", [False, True])
def test_rdma_self_ring_chain_replayed_three_times(card, fused):
    """One capture of a periodic self-ring chain, replayed three times on
    its own output, equals the eager chain after every replay: each
    replayed launch reads a new epoch from the pad."""
    K = 8
    if fused:
        run = TH.iterate_fused_rdma_fn(K, 1e-4, axis=0, steps=4,
                                       periodic=True)
        z = rand(card, (384 + 2 * K, 256), torch.float32, seed=11)
    else:
        run = TH.iterate_hand_fn(K, 1e-4, axis=1, steps=4, periodic=True,
                                 rdma=True)
        z = rand(card, (256, 384 + 2 * K), torch.float32, seed=12)
    assert CS.replay_check(f"self-ring fused={fused}", run, z, calls=6,
                           replays=3) == 3


def test_graph_chain_keeps_the_route_counts(card):
    """The counts after a graph chain are the launches the card ran: the
    same, per kernel and per route, as the eager chain's."""
    from tpu_mpi_tests_torch.instrument.timers import chain_rate

    run = TH.iterate_hand_fn(8, 1e-4, axis=1, steps=4, periodic=True,
                             rdma=True)
    z = rand(card, (256, 272), torch.float32, seed=13)
    got = {}
    for graph in (False, None):
        hand.reset_launch_counts()
        chain_rate(run, z.clone(), n_short=4, n_long=20, repeats=2,
                   graph=graph)
        got[graph] = (hand.launch_counts(), hand.route_counts())
    assert got[None] == got[False]
    assert got[None][0]["ring_halo"] == 3 + 2 * (4 + 20)
    assert got[None][0]["stencil2d_iterate"] == 3 + 2 * (4 + 20)


#: one process: seed the pad's launch counter (words 60-61, one 64-bit
#: word: the launches before, in its high half), then two periodic
#: self-ring halo launches, each waited for
_EPOCH_SCRIPT = """
import sys
import torch
from tpu_mpi_tests_torch.comm import peer
from tpu_mpi_tests_torch.kernels import hand

dev = torch.device("cuda", 0)
z = torch.zeros((64, 48), device=dev)
hand.ring_halo(z, 1, 8, True)
pad = peer.peer_ring(dev).pad
pad[60:62].view(torch.int64).fill_(int(sys.argv[1]) << 32)
for i in range(2):
    hand.ring_halo(z, 1, 8, True)
    torch.cuda.synchronize(dev)
    print("LAUNCHES", int(pad[61]), flush=True)
"""


@pytest.mark.parametrize("before, ran", [(5, [6, 7]),
                                         (2**31 - 2, [2**31 - 1])])
def test_epoch_overflow_traps(card, before, ran):
    """The launch after a pad's 2^31 - 1st fails (the kernel traps)
    instead of taking a wrapped epoch that meets every wait at once."""
    import subprocess
    import sys

    repo = Path(__file__).resolve().parent.parent
    r = subprocess.run([sys.executable, "-c", _EPOCH_SCRIPT, str(before)],
                       cwd=repo, capture_output=True, text=True, timeout=300)
    got = [int(line.split()[1]) for line in r.stdout.splitlines()
           if line.startswith("LAUNCHES")]
    assert got == ran, r.stdout + r.stderr
    assert (r.returncode == 0) == (len(ran) == 2), r.stderr


def test_a_launch_outside_the_capture_raises(card):
    """A hand launch that the capture counted but did not record (queued
    on a stream outside the capture, it runs once, eagerly) fails the
    graph chain: the graphs' kernel nodes are held against the counts."""
    from tpu_mpi_tests_torch.instrument.timers import chain_rate

    side = torch.cuda.Stream(card)
    src, dst = torch.ones(1024, device=card), torch.empty(1024, device=card)

    def run(x, n):
        for _ in range(n):
            with torch.cuda.stream(side):
                hand.daxpy(2.0, src, src, out=dst)
            x = x + 1
        return x

    with pytest.raises(RuntimeError, match="daxpy.*counted"):
        chain_rate(run, torch.zeros(1024, device=card), n_short=1,
                   n_long=3)
    torch.cuda.synchronize(card)


def _positive(x) -> float:
    """A host read (a helper's: the capture-purity rule is lexical)."""
    return float(x.sum().item() > 0)


def test_a_failed_capture_raises(card):
    """A body that reads to the host cannot be captured: the error is
    raised, with no eager chain in its place."""
    from tpu_mpi_tests_torch.instrument.timers import chain_rate

    def run(x, n):
        for _ in range(n):
            x = x + _positive(x)
        return x

    with pytest.raises(RuntimeError):
        chain_rate(run, torch.zeros(8, device=card), n_short=1, n_long=3)
    # the card is usable after it
    assert chain_rate(lambda x, n: x + n, torch.zeros(8, device=card),
                      n_short=1, n_long=3)[1].sum().item() == 8 * 7

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
out of place and in place, on ragged and misaligned operands; the DAXPY
drivers and the microbench groups run on the card at small sizes. The
flash-attention fold is held against its plain version within stated
tolerances (sums in another order; tensor-core operands rounded at
DEFAULT), dense and causal with masked, live and strided offsets, and in
the (L, H, d) layout in one launch. The ALU probe is held bit for bit
(``fma``, ``step5*``, ``heat5``) or within ``hand.alu_probe_tolerance``
(the dual mixes), with its chain property and capacity guard; pack and
unpack bit for bit on both axes, and the hand-staged exchange against
DIRECT; the dual step's lean body like the raw one; the ``vpu`` group
and the ``stencil1d`` driver run on the card at small sizes.
"""

import pytest
import torch

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
    z = rand(card, (40, 40), torch.float32, seed=1)
    with pytest.raises(ValueError, match="share storage"):
        hand.heat2d(z, 0.1, 0.1, out=z)
    deepest = hand.heat2d_max_steps(torch.float32)
    with pytest.raises(ValueError, match="shared memory"):
        hand.heat2d(z, 0.1, 0.1, steps=deepest + 1)


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
    the kernel writes into a copy of its last operand."""
    kernel, plain = getattr(hand, name), getattr(hand, f"{name}_ref")
    args = ops if name == "stream_sum3" else (a, *ops)
    want = plain(*args)
    if inplace:
        tgt = args[-1].clone()
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
    # dispatch_rate 1 + 100 + 1100 calls; chain_rate 3 + n_short + n_long
    assert counts["daxpy"] == 1201 + 2 * 1203 + 1201 + 1103 + 333
    assert counts["stream_scale"] == 1201 + 1103
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


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("n_bnd", [2, 8])
def test_hand_staged_exchange_equals_direct(card, axis, n_bnd):
    z = rand(card, (64 + 2 * n_bnd, 96 + 2 * n_bnd), torch.float32, seed=16)
    hand.reset_launch_counts()
    got = TH.halo_exchange(z.clone(), axis, n_bnd, True, "device",
                           kernel="hand")
    counts = hand.launch_counts()
    assert counts["pack_edges"] == 1 and counts["unpack_ghosts"] == 1
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

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
drivers and the microbench groups run on the card at small sizes.
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

"""The hand CUDA kernels on the card (marker ``cuda``; skipped without a
GPU). Run them on a machine with one:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py

(``--noconftest``: the suite's conftest imports jax, which the port's
machine need not have; this file imports only torch and the port.)

Each kernel is held against its plain version on the same CUDA tensors,
bit for bit (the kernels round where the eager torch ops round), and a
wrapper given a CUDA tensor returns a CUDA tensor and counts a launch.
"""

import pytest
import torch

from tpu_mpi_tests_torch.comm import halo as TH
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

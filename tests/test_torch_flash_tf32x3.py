"""The tf32x3 route's arithmetic, on the CPU.

The route (``csrc/flash_fold.cuh``, float32 HIGHEST at d <= 128) splits
every f32 operand into a TF32 big part and a TF32 small remainder and
accumulates small·big + big·small + big·big on the tensor cores. Its
plain-torch emulation (``hand.tf32_round``, ``hand.tf32_split``,
``hand.tf32x3_matmul``, ``hand.flash_attention_tf32x3_emulated``) is held
here against exact arithmetic and against the JAX package's
``flash_attention_pallas`` at HIGHEST in interpret mode, at d = 128 and a
few hundred keys, to ``chip_smoke.FLASH_RTOL`` / ``FLASH_ATOL`` (1e-5,
the bound the kernel is held to on the card). One TF32 pass — the DEFAULT
route's arithmetic — misses that bound: the control case.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_mpi_tests.kernels.pallas_kernels import flash_attention_pallas
from tpu_mpi_tests_torch.kernels import hand

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
CS = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(CS)

F32 = np.float32


def f32(*values):
    return torch.tensor(values, dtype=torch.float32)


def test_tf32_round_to_nearest_ties_away_from_zero():
    ulp = 2.0**-10  # a TF32 ulp at 1
    x = f32(1.0, 1 + ulp / 4, 1 + ulp / 2, 1 + 3 * ulp / 4, -(1 + ulp / 2),
            1 + ulp / 2 - 2.0**-23, 3.0, 0.0, -0.0)
    want = f32(1.0, 1.0, 1 + ulp, 1 + ulp, -(1 + ulp), 1.0, 3.0, 0.0, -0.0)
    assert torch.equal(hand.tf32_round(x), want)
    trunc = f32(1.0, 1.0, 1.0, 1.0, -1.0, 1.0, 3.0, 0.0, -0.0)
    assert torch.equal(hand.tf32_round(x, truncate=True), trunc)
    special = f32(float("inf"), float("-inf"))
    assert torch.equal(hand.tf32_round(special), special)
    assert bool(hand.tf32_round(f32(float("nan"))).isnan().all())
    # 13 low bits clear on every result
    r = hand.tf32_round(torch.randn(1000))
    assert int((r.view(torch.int32) & 0x1FFF).abs().max()) == 0


def test_tf32_round_refuses_other_dtypes():
    with pytest.raises(TypeError, match="float32"):
        hand.tf32_round(torch.ones(3, dtype=torch.float64))


@pytest.mark.parametrize("truncate,bound", [(False, 2.0**-22),
                                            (True, 2.0**-21)])
def test_split_leaves_a_residual_under_its_bound(truncate, bound):
    rng = np.random.default_rng(1)
    x = torch.from_numpy((rng.normal(size=10000) *
                          10.0**rng.integers(-6, 6, 10000)).astype(F32))
    big, small = hand.tf32_split(x, truncate=truncate)
    for part in (big, small):
        assert int((part.view(torch.int32) & 0x1FFF).abs().max()) == 0
    rest = x.double() - big.double() - small.double()
    assert bool((rest.abs() <= bound * x.double().abs()).all())


def test_tf32x3_matmul_is_f32_accurate_and_one_pass_is_not():
    rng = np.random.default_rng(2)
    a = torch.from_numpy(rng.normal(size=(64, 128)).astype(F32))
    b = torch.from_numpy(rng.normal(size=(128, 64)).astype(F32))
    exact = a.double() @ b.double()
    scale = a.double().abs() @ b.double().abs()  # Σ|a·b| per element
    err3 = float(((hand.tf32x3_matmul(a, b).double() - exact) / scale)
                 .abs().max())
    err1 = float(((hand.tf32x3_matmul(a, b, passes=1).double() - exact)
                  / scale).abs().max())
    assert err3 <= 2e-6, err3
    assert err1 >= 1e-4, err1
    with pytest.raises(ValueError, match="passes"):
        hand.tf32x3_matmul(a, b, passes=2)


def _operands(seed, L, d):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(L, d)).astype(F32) for _ in range(3))


def _pallas_highest(q, k, v, causal):
    return np.asarray(flash_attention_pallas(
        *(jnp.asarray(a) for a in (q, k, v)), causal=causal, q_tile=64,
        k_tile=hand.FLASH_K_TILES["tf32x3"], interpret=True,
        precision=jax.lax.Precision.HIGHEST))


@pytest.mark.parametrize("truncate", [False, True])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("L", [192, 320])
def test_emulated_fold_matches_pallas_highest(L, causal, truncate):
    """The 3xTF32 fold (both big-part roundings the kernel can compile)
    against the JAX kernel at HIGHEST, at the card's tolerance."""
    q, k, v = _operands(L + causal, L, 128)
    want = _pallas_highest(q, k, v, causal)
    got = hand.flash_attention_tf32x3_emulated(
        *(torch.from_numpy(a) for a in (q, k, v)), causal=causal,
        truncate=truncate)
    np.testing.assert_allclose(got.numpy(), want, rtol=CS.FLASH_RTOL,
                               atol=CS.FLASH_ATOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("L", [192, 320])
def test_one_tf32_pass_misses_the_tolerance(L, causal):
    """The control: the same fold with one TF32 pass a product is off the
    JAX kernel by far more than the bound the 3xTF32 fold meets."""
    q, k, v = _operands(L + causal, L, 128)
    want = _pallas_highest(q, k, v, causal)
    got = hand.flash_attention_tf32x3_emulated(
        *(torch.from_numpy(a) for a in (q, k, v)), causal=causal, passes=1)
    gap = np.abs(got.numpy() - want) - (CS.FLASH_ATOL +
                                        CS.FLASH_RTOL * np.abs(want))
    assert gap.max() > 0
    assert np.abs(got.numpy() - want).max() > 10 * CS.FLASH_ATOL


def test_tolerance_is_the_cards():
    assert CS.FLASH_RTOL == CS.FLASH_ATOL == 1e-5


def test_emulated_fold_refuses_bf16_and_heads():
    q = torch.zeros(8, 16, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="float32"):
        hand.flash_attention_tf32x3_emulated(q, q, q)
    q = torch.zeros(8, 2, 16)
    with pytest.raises(ValueError, match="float32"):
        hand.flash_attention_tf32x3_emulated(q, q, q)


@pytest.mark.parametrize("dtype,fast,tier,peak", [
    ("float32", False, "flash", 495e12 / 3),
    ("float32", False, "ring", 495e12 / 3),
    ("float32", False, "xla", 67e12),
    ("bfloat16", False, "flash", 67e12),
    ("bfloat16", False, "xla", 989e12),
    ("float32", True, "flash", 495e12),
    ("bfloat16", True, "ulysses", 989e12),
])
def test_chip_smoke_holds_each_row_to_its_arithmetic(dtype, fast, tier,
                                                     peak):
    """attnbench's float32 HIGHEST rows run on the tf32x3 route: their
    TFLOP/s are held to a third of TF32's peak, not to the CUDA cores'."""
    assert CS.attn_peak(dtype, fast, tier) == pytest.approx(peak)


@pytest.mark.parametrize("route,dtype,arith", [
    ("tf32x3", torch.float32, "tf32x3"), ("fma", torch.float32, "f32"),
    ("fma", torch.bfloat16, "f32"), ("mma", torch.float32, "tf32"),
    ("wgmma", torch.bfloat16, "bf16"), ("mma", torch.bfloat16, "bf16")])
def test_chip_smoke_bound_of_each_route(route, dtype, arith):
    assert CS.flash_arith(route, dtype) == arith
    assert arith in CS.PEAK_FLOPS

"""The port's ALU probe (``hand.alu_probe``; on a CPU tensor, its plain
version) against the JAX package's ``vpu_probe_pallas`` in interpret
mode, on the same numpy-seeded blocks.

All eight mixes × float32/bfloat16 × the JAX tests' shapes (16, 128) and
(8, 128), reps 2 and 3, a visible ``se``. Tolerances, the JAX tests' own
(``tests/test_pallas.py:563-741``) as the ceiling and tighter where the
arithmetic allows:

* float32 ``fma``, ``step5*``, ``heat5``: 2e-6 absolute on O(1)–O(100)
  fields — the port rounds after every op; XLA on the CPU contracts some
  ``a·b + c`` pairs of the compiled body into FMAs, which differ by the
  product's rounding (the JAX tests allow 1e-4 / 1e-5);
* float32 dual mixes: 1e-5 (the residual is a sum in another order on
  top; the JAX tests allow 1e-3);
* bfloat16 ``fma``, ``step5*``, ``heat5``: 0 — both sides round every op
  to bf16;
* bfloat16 dual mixes: two bf16 ulps of the largest value per rep (the
  fed-back sum is taken in another order; observed 0 at these shapes).

Also here: a (B, H, W) stack advances each block on its own, the chain
property, the mix and shape checks, the capacity guard, and the lean
coefficient fold.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_mpi_tests.kernels import pallas_kernels as PK
from tpu_mpi_tests_torch.convert import array_from_jax
from tpu_mpi_tests_torch.kernels import hand

SE = 0.05
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def block(seed, shape, dtype):
    a = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return jnp.asarray(a, JNP[dtype])


def tolerance(mix, dtype, reps, want):
    dual = mix.startswith("dualdim")
    if dtype == "bfloat16":
        return 2 * reps * 2.0**-8 * float(np.abs(want).max()) if dual else 0
    return 1e-5 if dual else 2e-6


@pytest.mark.parametrize("dtype", list(JNP))
@pytest.mark.parametrize("shape,reps", [((16, 128), 3), ((8, 128), 2)])
@pytest.mark.parametrize("mix", hand.ALU_PROBE_MIXES)
def test_probe_matches_pallas(mix, shape, reps, dtype):
    z = block(7, shape, dtype)
    want = np.asarray(PK.vpu_probe_pallas(z + 0, reps, mix, se=SE,
                                          interpret=True), np.float32)
    before = hand.alu_probe.launches
    got = hand.alu_probe(array_from_jax(z), reps, mix, se=SE)
    assert hand.alu_probe.launches == before  # the plain version ran
    assert got.dtype == array_from_jax(z).dtype and got.shape == shape
    err = np.abs(got.float().numpy() - want).max()
    assert err <= tolerance(mix, dtype, reps, want), err
    # the update is visible, or the comparison proves nothing
    assert np.abs(want - np.asarray(z, np.float32)).max() > 1e-4


@pytest.mark.parametrize("mix", hand.ALU_PROBE_MIXES)
def test_batched_blocks_advance_independently(mix):
    z = torch.from_numpy(np.random.default_rng(3).normal(
        size=(3, 16, 128)).astype(np.float32))
    got = hand.alu_probe(z, 2, mix, se=SE)
    assert got.shape == z.shape
    for b in range(3):
        assert torch.equal(got[b], hand.alu_probe(z[b], 2, mix, se=SE))


@pytest.mark.parametrize("mix", hand.ALU_PROBE_MIXES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chain_property(mix, dtype):
    z = torch.from_numpy(np.random.default_rng(4).normal(
        size=(37, 200)).astype(np.float32)).to(dtype)
    once = hand.alu_probe(z, 5, mix, se=SE)
    twice = hand.alu_probe(hand.alu_probe(z, 2, mix, se=SE), 3, mix, se=SE)
    assert torch.equal(once, twice)
    assert not torch.equal(once, z)


def test_probe_rejects_bad_arguments():
    z = torch.zeros(16, 128)
    with pytest.raises(ValueError, match="unknown mix"):
        hand.alu_probe(z, 2, "fmaa")
    with pytest.raises(ValueError, match="reps"):
        hand.alu_probe(z, 0)
    with pytest.raises(TypeError, match="float64"):
        hand.alu_probe(z.double(), 2)
    with pytest.raises(ValueError, match="too small"):
        hand.alu_probe(torch.zeros(4, 128), 2, "step5_d0")
    with pytest.raises(ValueError, match="too small"):
        hand.alu_probe(torch.zeros(16, 4), 2, "dualdim")
    with pytest.raises(ValueError, match=r"\(H, W\)"):
        hand.alu_probe(torch.zeros(128), 2)


def test_capacity_guard_names_the_l2():
    """The port's counterpart of the Pallas probe's VMEM guard
    (``test_vpu_probe_rejects_vmem_blowout``): two ping-pong buffers must
    fit in the card's L2 cache."""
    hand.check_probe_capacity(8 << 20, 50 << 20)
    with pytest.raises(ValueError, match="L2"):
        hand.check_probe_capacity(26 << 20, 50 << 20)


def test_shifts_and_tolerance():
    z = torch.from_numpy(np.random.default_rng(5).normal(
        size=(16, 128)).astype(np.float32))
    shifts = []
    hand.alu_probe_ref(z, 3, "dualdim", se=SE, shifts=shifts)
    assert len(shifts) == 3 and all(s > 0 for s in shifts)
    none = []
    hand.alu_probe_ref(z, 3, "heat5", shifts=none)
    assert none == []
    tol = hand.alu_probe_tolerance(torch.float32, 3, 4.0, max(shifts))
    assert 0 < tol < 1e-4
    assert hand.alu_probe_tolerance(torch.bfloat16, 3, 4.0, max(shifts)) > tol


def test_real_op_counts_cover_every_mix():
    assert set(hand.ALU_PROBE_REAL_OPS) == set(hand.ALU_PROBE_MIXES)
    src = open(PK.__file__).read()
    for mix in hand.ALU_PROBE_MIXES:
        assert f'"{mix}"' in src  # the JAX mix names, unchanged


def test_lean_coefficients_fold_in_float32():
    """``c = dtype(f32(s)·f32(C))``: the product is taken in float32 and
    cast once (``pallas_kernels.py:1549-1554``)."""
    c1, c2 = hand._lean_coefs(1.5, torch.float32)
    assert c1 == float(np.float32(np.float32(1.5) * np.float32(2.0 / 3.0)))
    assert c2 == float(np.float32(np.float32(1.5) * np.float32(-1.0 / 12.0)))
    b1, _ = hand._lean_coefs(1.5, torch.bfloat16)
    assert b1 == torch.tensor(c1).to(torch.bfloat16).item()

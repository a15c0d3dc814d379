"""``state_from_jax``: the JAX package's state becomes the port's tensors
bit for bit — float32, float64 and bfloat16 (which travels as its 16-bit
pattern), one ghosted domain or an S-tuple of resident blocks."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_mpi_tests.comm import halo as JH
from tpu_mpi_tests_torch.comm import halo as TH
from tpu_mpi_tests_torch.convert import array_from_jax, state_from_jax

DTYPES = [(jnp.float32, torch.float32), (jnp.float64, torch.float64),
          (jnp.bfloat16, torch.bfloat16)]


def bits(a):
    """The raw bit pattern of a numpy array (bf16 included)."""
    a = np.asarray(a)
    return a.view({2: np.uint16, 4: np.uint32, 8: np.uint64}[a.itemsize])


def tbits(t):
    return t.view({2: torch.int16, 4: torch.int32,
                   8: torch.int64}[t.element_size()]).numpy().view(
        {2: np.uint16, 4: np.uint32, 8: np.uint64}[t.element_size()])


@pytest.mark.parametrize("jdt,tdt", DTYPES)
def test_domain_bit_exact(jdt, tdt):
    z = np.random.default_rng(0).normal(size=(13, 9)) * 1e3
    zj = jnp.asarray(z, jdt)
    t = state_from_jax(zj)
    assert isinstance(t, torch.Tensor)
    assert t.dtype == tdt and t.shape == zj.shape and t.device.type == "cpu"
    np.testing.assert_array_equal(tbits(t), bits(zj))
    # an owned, writable copy: writing it leaves the JAX array alone
    t.zero_()
    np.testing.assert_array_equal(bits(zj), bits(jnp.asarray(z, jdt)))


@pytest.mark.parametrize("jdt,tdt", DTYPES)
def test_block_tuple_bit_exact(jdt, tdt):
    K, S = 4, 2
    z = jnp.asarray(np.random.default_rng(1).normal(size=(2 * 10 + 2 * K, 6)),
                    jdt)
    blocks_j = JH.split_blocks(z, S, K)
    blocks_t = state_from_jax(blocks_j)
    assert isinstance(blocks_t, tuple) and len(blocks_t) == S
    for bt, bj in zip(blocks_t, blocks_j):
        assert bt.dtype == tdt
        np.testing.assert_array_equal(tbits(bt), bits(bj))
    # the converted tuple is what the port's own split gives
    for bt, bs in zip(blocks_t, TH.split_blocks(array_from_jax(z), S, K)):
        assert torch.equal(bt, bs)


def test_special_values_survive():
    z = np.array([[0.0, -0.0, np.inf], [-np.inf, np.nan, 1e-40]])
    for jdt, _ in DTYPES:
        zj = jnp.asarray(z, jdt)
        np.testing.assert_array_equal(tbits(array_from_jax(zj)), bits(zj))

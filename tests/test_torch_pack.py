"""The port's halo staging copies against the JAX package's, on the CPU:
``hand.pack_edges`` / ``hand.unpack_ghosts`` (on a CPU tensor, their plain
versions, which are ``kernels.pack``) against ``pack_edges_pallas`` /
``unpack_ghosts_pallas`` in interpret mode and against the XLA
``kernels/pack.py``, on the same numpy-seeded arrays. Pure copies:
tolerance 0 in every dtype.

Also the round trip of ``tests/test_pallas.py:395``, the in-place
contract of the port's ``unpack_ghosts`` (the JAX function returns an
updated copy), ``interior``, and the band checks.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_mpi_tests.kernels import pack as JP
from tpu_mpi_tests.kernels import pallas_kernels as PK
from tpu_mpi_tests_torch.convert import array_from_jax
from tpu_mpi_tests_torch.kernels import hand
from tpu_mpi_tests_torch.kernels import pack as TP

DTYPES = {"float64": np.float64, "float32": np.float32,
          "bfloat16": jnp.bfloat16}


def field(seed, shape, dtype):
    a = np.random.default_rng(seed).normal(size=shape)
    return jnp.asarray(a.astype(np.float32), DTYPES[dtype])


def same(t: torch.Tensor, a) -> bool:
    return np.array_equal(t.double().numpy(), np.asarray(a, np.float64))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("n_bnd", [1, 2, 3])
def test_pack_unpack_match_pallas_and_xla(dtype, axis, n_bnd):
    z = field(20 + axis, (16, 24), dtype)
    plo, phi = PK.pack_edges_pallas(z, axis=axis, n_bnd=n_bnd,
                                    interpret=True)
    xlo, xhi = JP.pack_edges(z, axis=axis, n_bnd=n_bnd)
    zt = array_from_jax(z)
    before = hand.launch_counts()
    lo, hi = hand.pack_edges(zt, axis, n_bnd)
    assert lo.is_contiguous() and hi.is_contiguous()
    assert same(lo, plo) and same(hi, phi)
    assert same(lo, xlo) and same(hi, xhi)
    tlo, thi = TP.pack_edges(zt, axis, n_bnd)
    assert torch.equal(lo, tlo) and torch.equal(hi, thi)

    want = PK.unpack_ghosts_pallas(z, phi, plo, axis=axis, n_bnd=n_bnd,
                                   interpret=True)
    assert np.array_equal(np.asarray(want, np.float64), np.asarray(
        JP.unpack_ghosts(z, xhi, xlo, axis=axis, n_bnd=n_bnd), np.float64))
    got = hand.unpack_ghosts(zt, hi, lo, axis, n_bnd)
    assert got is zt  # in place: the port's design difference
    assert same(got, want)
    assert hand.launch_counts() == before  # the plain versions ran


@pytest.mark.parametrize("axis", [0, 1])
def test_round_trip_like_the_pallas_test(axis):
    """``tests/test_pallas.py::test_pack_unpack_roundtrip``: the ghosts
    take the packed edges, the interior is untouched."""
    z = torch.from_numpy(np.arange(12 * 12, dtype=np.float32)
                         .reshape(12, 12))
    lo, hi = hand.pack_edges(z, axis, 2)
    out = hand.unpack_ghosts(z.clone(), lo, hi, axis, 2)
    assert torch.equal(out.narrow(axis, 0, 2), lo)
    assert torch.equal(out.narrow(axis, 10, 2), hi)
    assert torch.equal(TP.interior(out, axis, 2), TP.interior(z, axis, 2))
    assert TP.interior(z, axis, 2).shape[axis] == 8


def test_pack_accepts_any_rank_as_torch_ops_only():
    z1 = torch.arange(10.0)
    lo, hi = TP.pack_edges(z1, 0, 2)
    assert lo.tolist() == [2.0, 3.0] and hi.tolist() == [6.0, 7.0]
    with pytest.raises(ValueError, match="2-D"):
        hand.pack_edges(z1, 0, 2)


def test_band_checks():
    z = torch.zeros(3, 8)
    with pytest.raises(ValueError, match="bands"):
        hand.pack_edges(z, 0, 2)
    with pytest.raises(ValueError, match="n_bnd"):
        hand.pack_edges(z, 1, 0)
    with pytest.raises(ValueError, match="axis"):
        hand.pack_edges(z, 2, 1)
    lo, hi = hand.pack_edges(z, 1, 2)
    with pytest.raises(ValueError, match="must be"):
        hand.unpack_ghosts(z, lo[:, :1], hi, 1, 2)
    with pytest.raises(ValueError, match="must be"):
        hand.unpack_ghosts(z, lo.double(), hi.double(), 1, 2)

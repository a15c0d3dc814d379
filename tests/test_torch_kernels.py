"""The port's kernels module by module against the JAX package, on the CPU.

Inputs come from a seeded numpy generator and go through both the JAX
function and the port's counterpart: the torch-op stencils and
reductions against the XLA formulations, and the hand kernels' plain
versions (``stencil2d_deriv_ref``, ``stencil2d_iterate_ref``) against the
Pallas kernels they replace, run in interpret mode as
``tests/test_pallas.py`` runs them. ``stencil2d_iterate_pallas`` donates
its input, so every call gets a fresh array.

Tolerances. float64 and float32: the port repeats the JAX op order, and
is exact against the XLA-tier stencil; against an interpreted Pallas body
XLA may contract a mul+add into one FMA, so results differ by a few ulp —
rtol/atol 1e-13 (f64) and 1e-6 (f32). bfloat16: within one bf16 ulp of
the array's magnitude (2**-7 relative), since both sides round every op
to bf16 but XLA may keep an intermediate wider.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_mpi_tests.kernels import pallas_kernels as PK
from tpu_mpi_tests.kernels import reductions as JR
from tpu_mpi_tests.kernels import stencil as JS
from tpu_mpi_tests_torch.convert import array_from_jax
from tpu_mpi_tests_torch.kernels import hand
from tpu_mpi_tests_torch.kernels import reductions as TR
from tpu_mpi_tests_torch.kernels import stencil as TS

DTYPES = {"float64": np.float64, "float32": np.float32,
          "bfloat16": jnp.bfloat16}


def sample(seed, shape, dtype="float64"):
    """Seeded normal samples as numpy in ``dtype`` (bf16 via ml_dtypes)."""
    a = np.random.default_rng(seed).normal(size=shape)
    return a.astype(np.float32).astype(DTYPES[dtype])


def assert_close(got, want, dtype):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    if dtype == "bfloat16":
        tol = 2.0**-7 * max(float(np.abs(want).max()), 1.0)
        np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    else:
        tol = 1e-13 if dtype == "float64" else 1e-6
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def to_np(t):
    return t.double().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def test_constants_match():
    np.testing.assert_array_equal(TS.STENCIL5, JS.STENCIL5)
    assert TS.N_BND == JS.N_BND


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("dtype", ["float64", "float32", "bfloat16"])
def test_stencil1d_5_matches_xla(axis, dtype):
    """The torch-op stencil is the XLA tier's op order, so it is exact."""
    z = sample(1 + axis, (23, 19), dtype)
    want = np.asarray(JS.stencil1d_5(jnp.asarray(z), 3.0, axis=axis))
    got = TS.stencil1d_5(array_from_jax(z), 3.0, axis=axis)
    np.testing.assert_array_equal(to_np(got), np.asarray(want, np.float64)
                                  if dtype == "bfloat16" else want)


def test_stencil1d_5_rejects_short_axis():
    with pytest.raises(ValueError):
        TS.stencil1d_5(torch.zeros(4, 3), axis=0)


def test_dual_dim_step_matches_xla():
    z = sample(3, (20, 26))
    jx, jy, jr = JS.dual_dim_step(jnp.asarray(z), 2, 2.0, 0.5)
    tx, ty, tr = TS.dual_dim_step(torch.from_numpy(z), 2, 2.0, 0.5)
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    np.testing.assert_allclose(float(tr), float(jr), rtol=1e-13)
    with pytest.raises(ValueError):
        TS.dual_dim_step(torch.from_numpy(z), 3, 1.0, 1.0)


def test_analytic_pairs_match():
    x = np.linspace(-2.0, 3.0, 7)
    y = np.linspace(1.0, 4.0, 7)
    tp, jp = TS.analytic_pairs(), JS.analytic_pairs()
    assert tp.keys() == jp.keys()
    for key in tp:
        for tf, jf in zip(tp[key], jp[key]):
            args = (x,) if key == "1d" else (x, y)
            np.testing.assert_array_equal(tf(*args), jf(*args))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_reductions_match(dtype):
    a, b = sample(4, (17, 9), dtype), sample(5, (17, 9), dtype)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    assert_close(float(TR.sum_squares(ta)), float(JR.sum_squares(ja)), dtype)
    assert_close(float(TR.err_norm(ta, tb)), float(JR.err_norm(ja, jb)),
                 dtype)
    for axis in (0, 1):
        assert_close(TR.sum_axis(ta, axis).numpy(),
                     np.asarray(JR.sum_axis(ja, axis)), dtype)


@pytest.mark.parametrize("dim", [0, 1])
@pytest.mark.parametrize("dtype", ["float64", "float32", "bfloat16"])
def test_deriv_ref_matches_pallas(dim, dtype):
    shape = (37, 29) if dim == 0 else (29, 37)
    z = sample(10 + dim, shape, dtype)
    want = np.asarray(PK.stencil2d_pallas(jnp.asarray(z), 2.0, dim=dim,
                                          interpret=True))
    got = hand.stencil2d_deriv_ref(array_from_jax(z), 2.0, dim=dim)
    assert_close(to_np(got), want, dtype)


def test_deriv_wrapper_on_cpu_is_the_plain_version():
    z = torch.from_numpy(sample(12, (21, 13)))
    before = hand.stencil2d_deriv.launches
    out = torch.empty(17, 13, dtype=torch.float64)
    got = hand.stencil2d_deriv(z, 4.0, dim=0, out=out)
    assert got is out
    torch.testing.assert_close(got, hand.stencil2d_deriv_ref(z, 4.0, dim=0),
                               rtol=0, atol=0)
    assert hand.stencil2d_deriv.launches == before  # no kernel launched


def _iterate_kwargs(flags):
    """(JAX kwargs, port kwargs) for a flag spec."""
    if flags == "dynamic":
        return ({"phys": jnp.asarray([1, 0], jnp.int32)},
                {"phys": torch.tensor([1, 0], dtype=torch.int32)})
    if flags == "none":
        return {}, {}
    return {"phys_static": flags}, {"phys_static": flags}


@pytest.mark.parametrize("dim", [0, 1])
@pytest.mark.parametrize("steps", [1, 2, 4])
@pytest.mark.parametrize("flags",
                         [(0, 0), (1, 1), (1, 0), (0, 1), "dynamic", "none"])
def test_iterate_ref_matches_pallas(dim, steps, flags):
    """Whole arrays, ghost rows included: on exchange-fed sides rows
    [N_BND, K) come back partly advanced, and both must agree there."""
    K = 2 * steps
    shape = (29 + 2 * K, 21) if dim == 0 else (21, 29 + 2 * K)
    z = sample(steps * 10 + dim, shape, "float32")
    jkw, tkw = _iterate_kwargs(flags)
    want = np.asarray(PK.stencil2d_iterate_pallas(
        jnp.asarray(z), 0.25, dim=dim, steps=steps, interpret=True, **jkw))
    got = hand.stencil2d_iterate_ref(torch.from_numpy(z), 0.25, dim=dim,
                                     steps=steps, **tkw)
    assert_close(got.numpy(), want, "float32")


@pytest.mark.parametrize("dtype", ["float64", "bfloat16"])
@pytest.mark.parametrize("dim", [0, 1])
def test_iterate_ref_matches_pallas_dtypes(dtype, dim):
    steps, K = 4, 8
    shape = (40 + 2 * K, 24) if dim == 0 else (24, 40 + 2 * K)
    z = sample(7 + dim, shape, dtype)
    want = np.asarray(PK.stencil2d_iterate_pallas(
        jnp.asarray(z), 0.1875, dim=dim, steps=steps, interpret=True,
        phys_static=(1, 0)))
    got = hand.stencil2d_iterate_ref(array_from_jax(z), 0.1875, dim=dim,
                                     steps=steps, phys_static=(1, 0))
    assert_close(to_np(got), want, dtype)


@pytest.mark.parametrize("steps", [1, 2, 4])
@pytest.mark.parametrize("flags", [(1, 1), (0, 0), "dynamic"])
def test_iterate_ref_matches_pallas_stream0(steps, flags):
    """The JAX row-streaming dim-0 path (``stream=True``, many ragged row
    blocks) computes the same function; the port's one kernel covers it."""
    K = 2 * steps
    z = sample(20 + steps, (70 + 2 * K, 24), "float32")
    jkw, tkw = _iterate_kwargs(flags)
    want = np.asarray(PK.stencil2d_iterate_pallas(
        jnp.asarray(z), 0.25, dim=0, steps=steps, stream=True,
        stream_tile_rows=16, interpret=True, **jkw))
    got = hand.stencil2d_iterate_ref(torch.from_numpy(z), 0.25, dim=0,
                                     steps=steps, **tkw)
    assert_close(got.numpy(), want, "float32")


@pytest.mark.parametrize("dim", [0, 1])
def test_iterate_inplace_step(dim):
    """≅ test_pallas.py::test_iterate_inplace_step: one step is
    ``interior += 0.5·D5`` with the ghosts preserved."""
    shape = (68, 64) if dim == 0 else (64, 68)
    z0 = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    got = hand.stencil2d_iterate(torch.from_numpy(z0), 0.5, dim=dim)
    ref = np.array(z0)
    sl = (slice(2, -2), slice(None)) if dim == 0 else (slice(None),
                                                      slice(2, -2))
    ref[sl] += 0.5 * np.asarray(JS.stencil1d_5(jnp.asarray(z0), 1.0,
                                               axis=dim))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)


@pytest.mark.parametrize("dim", [0, 1])
@pytest.mark.parametrize("steps", [2, 3])
@pytest.mark.parametrize("flags", ["static", "dynamic"])
def test_iterate_multistep_matches_repeated_single(dim, steps, flags):
    """≅ test_pallas.py's twin: a deep-halo k-step call reproduces k
    single-step calls on the interior (both sides physical) and leaves
    the physical band untouched."""
    K, m, other = 2 * steps, 40, 24
    shape = (m + 2 * K, other) if dim == 0 else (other, m + 2 * K)
    z0 = torch.from_numpy(sample(steps, shape, "float32"))
    kw = ({"phys_static": (1, 1)} if flags == "static"
          else {"phys": torch.tensor([1, 1])})
    got = hand.stencil2d_iterate(z0, 0.25, dim=dim, steps=steps, **kw)
    ref = z0.narrow(dim, K - 2, m + 4)
    for _ in range(steps):
        ref = hand.stencil2d_iterate(ref, 0.25, dim=dim)
    torch.testing.assert_close(got.narrow(dim, K, m), ref.narrow(dim, 2, m),
                               rtol=0, atol=1e-6)
    torch.testing.assert_close(got.narrow(dim, 0, K), z0.narrow(dim, 0, K),
                               rtol=0, atol=0)


def test_iterate_wrapper_on_cpu_is_the_plain_version():
    z = torch.from_numpy(sample(30, (30, 16)))
    out = torch.empty_like(z)
    before = hand.stencil2d_iterate.launches
    got = hand.stencil2d_iterate(z, 0.3, dim=0, steps=2,
                                 phys_static=(1, 0), out=out)
    assert got is out
    torch.testing.assert_close(
        got, hand.stencil2d_iterate_ref(z, 0.3, dim=0, steps=2,
                                        phys_static=(1, 0)),
        rtol=0, atol=0)
    assert hand.stencil2d_iterate.launches == before


def test_iterate_rejects_bad_arguments():
    z = torch.zeros(12, 8)
    with pytest.raises(ValueError):
        hand.stencil2d_iterate(z, 0.1, dim=0, steps=3)  # 12 <= 2·6
    with pytest.raises(ValueError):
        hand.stencil2d_iterate(z, 0.1, dim=0, steps=0)
    with pytest.raises(ValueError):
        hand.stencil2d_iterate(z, 0.1, dim=0, out=z)  # aliasing
    with pytest.raises(ValueError):
        hand.stencil2d_iterate(z, 0.1, dim=0, out=torch.zeros(12, 9))

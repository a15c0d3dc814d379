"""The routes of the port's flash fold, on the CPU.

The CUDA launchers (``csrc/flash_attention.cu``,
``csrc/fused_ring_attention.cu``) take the route the wrapper names and
refuse any other; the rule lives in ``hand.flash_route``: HIGHEST on the
CUDA cores ("fma"); DEFAULT through wgmma for bfloat16 at d <= 128 with
every operand in 16-byte chunks ("wgmma"), else through mma.sync ("mma").
Here: the route of every geometry class (dtype × precision × d ×
alignment) and the alignment rule on real tensors; the key tile that
``attnbench`` reports for the route its operands take; the plain version
folding at the wgmma route's key tile (128) against the JAX package's
``flash_attention_pallas`` and ``flash_attention_block_pallas`` in
interpret mode; the CPU wrappers still the plain version bit for bit, and
counting no launch on any route. The card's own tests of the route are in
``tests/test_torch_gpu.py``.

Tolerances: the block fold at HIGHEST in float32 at rtol 1e-5 / atol 5e-5
(the same recurrence in other tile sizes and summation orders); bf16
DEFAULT outputs to 8e-3 of each other plus one bf16 ulp of the output
(P rounded to bf16 on both sides, sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_mpi_tests.kernels.pallas_kernels import (
    flash_attention_block_pallas,
    flash_attention_pallas,
)
from tpu_mpi_tests_torch.comm import ring as TR
from tpu_mpi_tests_torch.convert import array_from_jax, state_from_jax
from tpu_mpi_tests_torch.drivers import attnbench
from tpu_mpi_tests_torch.kernels import hand

BF16, F32 = torch.bfloat16, torch.float32
WG_TILE = hand.FLASH_K_TILES["wgmma"]


def normal(rng, shape):
    return rng.normal(size=shape).astype(np.float32)


# ---------------------------------------------------------------------------
# the rule
# ---------------------------------------------------------------------------

ROUTE_CLASSES = [
    # dtype, precision, d, aligned, route
    (F32, "highest", 128, True, "fma"),
    (BF16, "highest", 128, True, "fma"),
    (BF16, "highest", 17, False, "fma"),
    (F32, "default", 128, True, "mma"),
    (F32, "default", 64, True, "mma"),
    (BF16, "default", 128, True, "wgmma"),
    (BF16, "default", 64, True, "wgmma"),
    (BF16, "default", 8, True, "wgmma"),
    (BF16, "default", 136, True, "mma"),
    (BF16, "default", 256, True, "mma"),
    (BF16, "default", 128, False, "mma"),
    (BF16, "default", 17, False, "mma"),
]


@pytest.mark.parametrize("dtype,precision,d,aligned,route", ROUTE_CLASSES)
def test_flash_route_of_each_geometry_class(dtype, precision, d, aligned,
                                            route):
    assert hand.flash_route(dtype, precision, d, aligned) == route
    assert route in hand.FLASH_ROUTES


def test_flash_route_refuses_unknown_precision():
    with pytest.raises(ValueError, match="precision"):
        hand.flash_route(BF16, "high", 128, True)


@pytest.mark.parametrize("make,d,aligned", [
    (lambda d: torch.zeros(100, d, dtype=BF16), 128, True),
    (lambda d: torch.zeros(100, d, dtype=BF16), 64, True),
    (lambda d: torch.zeros(100, d, dtype=BF16), 17, False),
    # a row start off the 16-byte grid: one element into the buffer
    (lambda d: torch.zeros(100 * d + 1, dtype=BF16)[1:].view(100, d), 128,
     False),
    # (L, H, d), heads inside the rows and outside them
    (lambda d: torch.zeros(50, 4, d, dtype=BF16), 128, True),
    (lambda d: torch.zeros(4, 50, d, dtype=BF16).transpose(0, 1), 64, True),
    # float32 moves in 4-element chunks
    (lambda d: torch.zeros(100, d, dtype=F32), 4, True),
    (lambda d: torch.zeros(100, d, dtype=F32), 6, False),
])
def test_flash_aligned_on_tensors(make, d, aligned):
    t = make(d)
    assert hand.flash_aligned(d, t, t, t) is aligned


def test_route_of_a_misaligned_bf16_operand_is_mma():
    q = torch.zeros(100, 128, dtype=BF16)
    k = torch.zeros(100 * 128 + 8, dtype=BF16)[8:].view(100, 128)
    assert hand.flash_aligned(128, q, k, q)  # 16 bytes in: still aligned
    k = torch.zeros(100 * 128 + 4, dtype=BF16)[4:].view(100, 128)
    assert not hand.flash_aligned(128, q, k, q)
    assert hand.flash_route(BF16, "default", 128,
                            hand.flash_aligned(128, q, k, q)) == "mma"


# ---------------------------------------------------------------------------
# the tiles attnbench reports
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,precision,d,route", [
    (BF16, "default", 128, "wgmma"),
    (BF16, "default", 64, "wgmma"),
    (BF16, "default", 256, "mma"),
    (F32, "default", 128, "mma"),
    (F32, "highest", 128, "fma"),
    (BF16, "highest", 128, "fma"),
])
def test_attnbench_reports_the_tile_of_the_route(dtype, precision, d, route):
    assert attnbench.card_k_tile(dtype, precision, d) == \
        hand.FLASH_K_TILES[route]


def test_route_tiles():
    assert set(hand.FLASH_K_TILES) == set(hand.FLASH_ROUTES)
    assert WG_TILE == 128
    assert hand.FLASH_K_TILES["fma"] == hand.FLASH_K_TILES["mma"] == 64
    assert hand.FLASH_Q_TILE == 64
    assert hand.FLASH_WGMMA_MAX_D == 128


# ---------------------------------------------------------------------------
# the plain version at the wgmma route's key tile against the JAX package
# ---------------------------------------------------------------------------

FOLD_CASES = [
    (False, 0, 0, 1),       # dense
    (True, 0, 0, 1),        # self-causal
    (True, 300, 41, 1),     # offsets: the diagonal inside the block
    (True, 3, 1, 4),        # the striped ring's form, p=3 of 4 from 1
    (True, 0, 1000, 1),     # every key in the future: fully masked
]


@pytest.mark.parametrize("causal,q_off,k_off,stride", FOLD_CASES)
def test_block_ref_at_the_wgmma_tile_matches_pallas(causal, q_off, k_off,
                                                    stride):
    rng = np.random.default_rng(5 + q_off + k_off + stride)
    L, Lk, d = 96, 300, 32
    q = normal(rng, (L, d))
    k, v = normal(rng, (Lk, d)), normal(rng, (Lk, d))
    m = normal(rng, (L, 1))
    l = np.abs(normal(rng, (L, 1))) + 0.5
    acc = normal(rng, (L, d))
    want = flash_attention_block_pallas(
        *(jnp.asarray(a) for a in (q, k, v, m, l, acc)), q_off, k_off,
        scale=d**-0.5, causal=causal, pos_stride=stride, q_tile=32,
        k_tile=WG_TILE, interpret=True)
    T = torch.from_numpy
    got = hand.flash_attention_block_ref(
        T(q), T(k), T(v), *state_from_jax((m, l, acc)), q_off, k_off,
        scale=d**-0.5, causal=causal, pos_stride=stride, k_tile=WG_TILE)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=5e-5)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("L,d", [(65, 128), (256, 128), (200, 64)])
def test_bf16_default_at_the_wgmma_tile_matches_pallas(causal, L, d):
    rng = np.random.default_rng(L + d + causal)
    jq, jk, jv = (jnp.asarray(rng.normal(size=(L, d)), jnp.bfloat16)
                  for _ in range(3))
    want = np.asarray(flash_attention_pallas(
        jq, jk, jv, causal=causal, q_tile=64, k_tile=WG_TILE,
        interpret=True, precision=jax.lax.Precision.DEFAULT
    ).astype(jnp.float32))
    q, k, v = (array_from_jax(a) for a in (jq, jk, jv))
    got = hand.flash_attention_ref(q, k, v, causal=causal,
                                   precision="default", k_tile=WG_TILE)
    assert got.dtype == BF16
    tol = 8e-3 + 2.0**-8 * np.abs(want).max()
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=tol)


# ---------------------------------------------------------------------------
# the CPU path: the plain version, no launch on any route
# ---------------------------------------------------------------------------

def test_cpu_wrappers_are_the_plain_version_and_count_no_route():
    hand.reset_launch_counts()
    assert hand.route_counts() == {
        name: dict.fromkeys(routes, 0)
        for name, routes in (
            ("flash_attention_block", hand.FLASH_ROUTES),
            ("fused_ring_attention", hand.FLASH_ROUTES),
            ("ring_allgather", hand.COLL_ROUTES),
            ("ring_reduce_scatter", hand.COLL_ROUTES),
            ("oneshot", hand.COLL_ROUTES),
            ("ring_halo", hand.COLL_ROUTES),
            ("pack_edges", hand.PACK_ROUTES),
            ("unpack_ghosts", hand.PACK_ROUTES),
            ("daxpy", hand.COLL_ROUTES),
            ("stream_scale", hand.COLL_ROUTES),
            ("stream_sum3", hand.COLL_ROUTES),
            ("stencil2d_iterate", hand.KSTEP_ROUTES),
            ("stencil2d_fused_rdma", hand.KSTEP_ROUTES),
            ("stencil2d_deriv", hand.DERIV_ROUTES),
            ("heat2d", hand.HEAT_ROUTES),
            ("dual_dim_step", hand.DUAL_ROUTES),
            ("alu_probe", hand.PROBE_ROUTES))}
    rng = np.random.default_rng(9)
    q, k, v = (torch.from_numpy(normal(rng, (130, 64))).to(BF16)
               for _ in range(3))
    for precision in hand.FLASH_PRECISIONS:
        got = hand.flash_attention(q, k, v, causal=True, precision=precision)
        want = hand.flash_attention_ref(q, k, v, causal=True,
                                        precision=precision)
        assert torch.equal(got, want)
        got = hand.fused_ring_attention(q, k, v, causal=True,
                                        precision=precision)
        want = hand.fused_ring_attention_ref(q, k, v, causal=True,
                                             precision=precision)
        assert torch.equal(got, want)
    assert all(n == 0 for r in hand.route_counts().values()
               for n in r.values())
    assert hand.flash_attention_block.launches == 0


def test_ring_attention_on_the_cpu_is_flash_attention_at_world1():
    """At world=1 the ring's flash tier folds the one block with the
    plain version: flash_attention's result to the last bit."""
    rng = np.random.default_rng(10)
    q, k, v = (torch.from_numpy(normal(rng, (96, 32))) for _ in range(3))
    for causal in (False, True):
        got = TR.ring_attention_fn(1, causal=causal, flash=True)(q, k, v)
        want = hand.flash_attention(q, k, v, causal=causal)
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


def test_reset_launch_counts_resets_the_routes():
    hand.flash_attention_block.launches_by_route["wgmma"] = 7
    hand.fused_ring_attention.launches_by_route["mma"] = 3
    hand.reset_launch_counts()
    assert hand.flash_attention_block.launches_by_route == \
        dict.fromkeys(hand.FLASH_ROUTES, 0)
    assert hand.fused_ring_attention.launches_by_route == \
        dict.fromkeys(hand.FLASH_ROUTES, 0)

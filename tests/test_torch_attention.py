"""The port's attention path against the JAX package's, on the CPU.

Pairs, on seeded numpy inputs: ``comm.ring.online_softmax_update`` (with
all-masked rows, both ``keepdims``); the flash kernel's plain version
(``hand.flash_attention_block_ref``, which the wrapper runs on a CPU
tensor) against ``flash_attention_block_pallas`` in interpret mode at
L=128, d=32, q_tile 32, k_tile 64, with masked, partly masked, fully live
and strided offsets; ``hand.flash_attention`` against
``flash_attention_pallas`` over the fuzz of ``tests/test_ring.py`` and its
bf16 precision gate; ``ring_attention`` and ``ulysses_attention`` at
world=1 against the JAX functions on a one-device mesh (worlds of 2 and 4
ranks: ``tests/test_torch_ring_dist.py``); the attnbench
driver's lines and rules; the microbench groups ``attention`` and
``causal`` at small sizes.

Tolerances (float32): the carries at rtol 1e-5 / atol 5e-5 and the
normalised outputs at atol 5e-5 — the plain version folds the same
recurrence in other tile sizes and summation orders than the interpreted
kernel; ``online_softmax_update`` at rtol 1e-6 (the same ops).
"""

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from tpu_mpi_tests.comm import alltoall as JA
from tpu_mpi_tests.comm import ring as JR
from tpu_mpi_tests.kernels.pallas_kernels import (
    flash_attention_block_pallas,
    flash_attention_pallas,
)
from tpu_mpi_tests_torch import microbench
from tpu_mpi_tests_torch.comm import alltoall as TA
from tpu_mpi_tests_torch.comm import ring as TR
from tpu_mpi_tests_torch.comm.mesh import MeshError
from tpu_mpi_tests_torch.convert import array_from_jax, state_from_jax
from tpu_mpi_tests_torch.drivers import attnbench
from tpu_mpi_tests_torch.kernels import hand
from tpu_mpi_tests_torch.utils import TpuMtError

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def mesh1():
    return Mesh(np.array(jax.devices()[:1]), ("shard",))


def normal(rng, shape):
    return rng.normal(size=shape).astype(np.float32)


def reference_attention(q, k, v, causal=False):
    """The f64 reference of ``tests/test_ring.py``."""
    s = (q @ k.T) / np.sqrt(q.shape[-1])
    if causal:
        L = s.shape[0]
        s = np.where(np.tril(np.ones((L, L), bool)), s, -np.inf)
    p = np.exp(s - s.max(axis=-1, keepdims=True))
    p /= p.sum(axis=-1, keepdims=True)
    return p @ v


# ---------------------------------------------------------------------------
# the recurrence
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("keepdims", [False, True])
def test_online_softmax_update_matches_jax(keepdims):
    rng = np.random.default_rng(3)
    m, l = normal(rng, (6,)), np.abs(normal(rng, (6,))) + 0.5
    s = normal(rng, (6, 10))
    s[1] = -np.inf          # an all-masked row over a live carry
    m[2], l[2] = -np.inf, 0.0
    s[2] = -np.inf          # an all-masked row over the empty carry
    s[3, :4] = -np.inf      # a partly masked row
    if keepdims:
        m, l = m[:, None], l[:, None]
    want = JR.online_softmax_update(jnp.asarray(m), jnp.asarray(l),
                                    jnp.asarray(s), keepdims=keepdims)
    got = TR.online_softmax_update(torch.from_numpy(m), torch.from_numpy(l),
                                   torch.from_numpy(s), keepdims=keepdims)
    for g, w in zip(got, want):
        assert not torch.isnan(g).any()
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)
    assert got[0][2].item() == -math.inf  # m stays -inf, no NaN


# ---------------------------------------------------------------------------
# the flash block fold
# ---------------------------------------------------------------------------

FOLD_OFFSETS = [
    (False, 0, 0, 1),        # dense
    (True, 0, 0, 1),         # self-causal: partly masked tiles
    (True, 0, 1000, 1),      # every key in the future: fully masked
    (True, 1000, 0, 1),      # every key in the past: fully live
    (True, 10, 100, 2),      # stride 2, the diagonal inside the block
    (True, 3, 0, 2),         # the striped ring's form, p=3 of a ring of 2
]


@pytest.mark.parametrize("causal,q_off,k_off,stride", FOLD_OFFSETS)
def test_flash_block_ref_matches_pallas(causal, q_off, k_off, stride):
    rng = np.random.default_rng(11 + q_off + k_off)
    L, d = 128, 32
    q, k, v = (normal(rng, (L, d)) for _ in range(3))
    m = normal(rng, (L, 1))
    l = np.abs(normal(rng, (L, 1))) + 0.5
    acc = normal(rng, (L, d))
    want = flash_attention_block_pallas(
        *(jnp.asarray(a) for a in (q, k, v, m, l, acc)), q_off, k_off,
        scale=d**-0.5, causal=causal, pos_stride=stride, q_tile=32,
        k_tile=64, interpret=True)
    T = torch.from_numpy
    carry = state_from_jax((m, l, acc))
    got = hand.flash_attention_block(
        T(q), T(k), T(v), *carry, q_off, k_off, scale=d**-0.5,
        causal=causal, pos_stride=stride)
    assert all(g is c for g, c in zip(got, carry))  # in place
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=5e-5)
    if (q_off, k_off) == (0, 1000):  # fully masked: the carry unchanged
        for g, a in zip(got, (m, l, acc)):
            np.testing.assert_array_equal(g.numpy(), a)


def test_flash_block_skip_spans_match_one_fold():
    """The plain version's TPU tile knobs change only the fold order."""
    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(normal(rng, (96, 16))) for _ in range(3))
    carry = hand._attention_carry(q)
    one = hand.flash_attention_block_ref(q, k, v, *carry, 0, 0, scale=0.25,
                                         causal=True)
    tiled = hand.flash_attention_block_ref(q, k, v, *carry, 0, 0,
                                           scale=0.25, causal=True,
                                           k_tile=32, skip_tile=8)
    for a, b in zip(one, tiled):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_flash_block_out_and_checks():
    q = torch.zeros(8, 4)
    m, l, acc = hand._attention_carry(q)
    out = tuple(torch.empty_like(t) for t in (m, l, acc))
    got = hand.flash_attention_block(q, q, q, m, l, acc, 0, 0, scale=1.0,
                                     out=out)
    assert all(g is o for g, o in zip(got, out))
    assert bool(torch.isneginf(m).all())  # the carry itself not written
    with pytest.raises(ValueError, match="head dim"):
        hand.flash_attention(torch.zeros(4, 257), torch.zeros(4, 257),
                             torch.zeros(4, 257))
    with pytest.raises(TypeError, match="float32 or"):
        z = torch.zeros(4, 8, dtype=torch.float64)
        hand.flash_attention(z, z, z)
    with pytest.raises(ValueError, match="precision"):
        hand.flash_attention(q, q, q, precision="high")
    with pytest.raises(ValueError, match="disjoint"):
        hand.flash_attention_block(q, q, q, m, l, acc, 0, 0, scale=1.0,
                                   out=(l, m, acc[:, :4].clone()))


def test_flash_attention_fuzz_matches_pallas():
    """The 8-trial fuzz of ``test_ring.py`` (same seed, same draws): both
    sides within 5e-5 of the f64 reference, the port's plain version
    folding at the drawn k_tile / skip_tile."""
    rng = np.random.default_rng(1)
    for _ in range(8):
        L = int(rng.integers(8, 260))
        d = int(rng.integers(4, 80))
        causal = bool(rng.integers(0, 2))
        qt = int(rng.integers(8, 300))
        kt = int(rng.integers(8, 300))
        skt = int(rng.integers(0, 80))
        q, k, v = (normal(rng, (L, d)) for _ in range(3))
        jax_out = np.asarray(flash_attention_pallas(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
            q_tile=qt, k_tile=kt, skip_tile=skt, interpret=True))
        got = hand.flash_attention(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            causal=causal, k_tile=kt, skip_tile=skt).numpy()
        ref = reference_attention(*(a.astype(np.float64) for a in (q, k, v)),
                                  causal=causal)
        msg = f"L={L} d={d} causal={causal} kt={kt} skt={skt}"
        np.testing.assert_allclose(jax_out, ref, atol=5e-5, err_msg=msg)
        np.testing.assert_allclose(got, ref, atol=5e-5, err_msg=msg)
        np.testing.assert_allclose(got, jax_out, atol=5e-5, err_msg=msg)


def test_flash_bf16_precision_gate():
    """The bf16 gate of ``test_ring.py``: at HIGHEST the bf16 output is
    within 8e-3 of the f64 reference of the bf16 inputs, and at least as
    close as DEFAULT (which rounds P to bf16)."""
    rng = np.random.default_rng(21)
    L, d = 256, 64
    jq, jk, jv = (jnp.asarray(rng.normal(size=(L, d)), jnp.bfloat16)
                  for _ in range(3))
    q, k, v = (array_from_jax(a) for a in (jq, jk, jv))
    ref = reference_attention(*(np.asarray(a, np.float64)
                                for a in (jq, jk, jv)), causal=True)
    got_hi = hand.flash_attention(q, k, v, causal=True).float().numpy()
    got_lo = hand.flash_attention(q, k, v, causal=True,
                                  precision="default").float().numpy()
    err_hi = np.abs(got_hi - ref).max()
    err_lo = np.abs(got_lo - ref).max()
    assert err_hi <= 8e-3, err_hi
    assert err_hi <= err_lo + 1e-6, (err_hi, err_lo)
    jax_hi = np.asarray(flash_attention_pallas(
        jq, jk, jv, causal=True, q_tile=64, k_tile=128, interpret=True
    ).astype(jnp.float32))
    assert np.abs(jax_hi - ref).max() <= 8e-3


def test_flash_attention_heads_layout_matches_vmap():
    rng = np.random.default_rng(4)
    q, k, v = (normal(rng, (100, 3, 16)) for _ in range(3))
    want = jax.vmap(
        lambda a, b, c: flash_attention_pallas(a, b, c, causal=True,
                                               interpret=True),
        in_axes=1, out_axes=1)(q, k, v)
    got = hand.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                               causal=True)
    assert got.shape == (100, 3, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5)


# ---------------------------------------------------------------------------
# ring and Ulysses at world=1
# ---------------------------------------------------------------------------

RING_CASES = [(flash, causal, False) for flash in (False, True)
              for causal in (False, True)] + [(False, True, True),
                                              (True, True, True)]


@pytest.mark.parametrize("flash,causal,stripe", RING_CASES)
def test_ring_attention_matches_jax(mesh1, flash, causal, stripe):
    rng = np.random.default_rng(7)
    q, k, v = (normal(rng, (128, 32)) for _ in range(3))
    jattn = JR.ring_attention_fn(mesh1, "shard", causal=causal, flash=flash,
                                 stripe=stripe, interpret=True)
    want = np.asarray(jattn(*(jnp.asarray(a) for a in (q, k, v))))
    tattn = TR.ring_attention_fn(1, causal=causal, flash=flash,
                                 stripe=stripe)
    got = tattn(*(torch.from_numpy(a) for a in (q, k, v)))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=5e-5)


@pytest.mark.parametrize("flash,causal,block_keys", [
    (False, False, 512), (False, True, 512), (False, True, 32),
    (True, False, 512), (True, True, 512)])
def test_ulysses_attention_matches_jax(mesh1, flash, causal, block_keys):
    rng = np.random.default_rng(5)
    q, k, v = (normal(rng, (100, 4, 16)) for _ in range(3))
    jattn = JA.ulysses_attention_fn(mesh1, "shard", causal=causal,
                                    block_keys=block_keys, flash=flash,
                                    interpret=True)
    want = np.asarray(jattn(*(jnp.asarray(a) for a in (q, k, v))))
    tattn = TA.ulysses_attention_fn(1, causal=causal, block_keys=block_keys,
                                    flash=flash)
    got = tattn(*(torch.from_numpy(a) for a in (q, k, v)))
    np.testing.assert_allclose(got.numpy(), want, atol=5e-5)


def test_ring_xla_tier_bf16_matches_jax(mesh1):
    """The torch-op tier keeps q's dtype end to end, as the XLA tier."""
    rng = np.random.default_rng(8)
    jq, jk, jv = (jnp.asarray(rng.normal(size=(64, 16)), jnp.bfloat16)
                  for _ in range(3))
    want = np.asarray(JR.ring_attention_fn(mesh1, "shard", causal=True)(
        jq, jk, jv).astype(jnp.float32))
    got = TR.ring_attention_fn(1, causal=True)(
        *(array_from_jax(a) for a in (jq, jk, jv)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=2e-2)


def test_striped_layout_matches_jax():
    x = np.arange(24 * 3, dtype=np.float32).reshape(24, 3)
    for world in (1, 4, 8):
        want = np.asarray(JR.to_striped(jnp.asarray(x), world))
        got = TR.to_striped(torch.from_numpy(x), world)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(
            TR.from_striped(got, world).numpy(), x)


def test_ring_scan_one_step_and_rules():
    blk = torch.arange(6.0)
    seen = []
    total = TR.ring_scan(lambda c, b, src: (seen.append(src), c + b.sum())[1],
                         torch.tensor(0.0), blk, depth=4)
    assert seen == [0] and total.item() == 15.0
    assert TR.ring_pass(blk) is blk
    q = torch.zeros(16, 4)
    # a world other than the process group's (one rank here) raises; the
    # paths over ranks run on gloo worlds in tests/test_torch_ring_dist.py
    with pytest.raises(MeshError, match="the process group has 1 rank"):
        TR.ring_attention(q, q, q, world=2)
    with pytest.raises(MeshError, match="the process group has 1 rank"):
        TA.ulysses_attention_fn(world=4)
    # the fused tier runs (its plain version on the CPU), equal to the
    # pipelined flash tier bit for bit
    assert torch.equal(TR.ring_attention(q, q, q, tier="fused"),
                       TR.ring_attention(q, q, q, flash=True))
    with pytest.raises(ValueError, match="ring tier must be one of"):
        TR.ring_attention(q, q, q, tier="bogus")
    with pytest.raises(ValueError, match="stripe=True only"):
        TR.ring_attention(q, q, q, stripe=True)


# ---------------------------------------------------------------------------
# the driver and the microbench groups
# ---------------------------------------------------------------------------

ATTN_ARGS = ["--device", "cpu", "--seq-len", "128", "--head-dim", "16",
             "--n-iter", "20"]
ROW_KEYS = {"kind", "tier", "L", "d", "dtype", "causal", "stripe", "tflops",
            "us_per_iter", "world"}


def test_attnbench_tiers_run_and_report(capsys, tmp_path):
    jsonl = tmp_path / "a.jsonl"
    before = hand.launch_counts()
    rc = attnbench.main(ATTN_ARGS + ["--tiers", "xla,flash,ring,ulysses",
                                     "--jsonl", str(jsonl)])
    out = capsys.readouterr().out
    assert rc == 0, out
    for tier in ("xla", "flash", "ring", "ulysses"):
        assert f"ATTN {tier} L=128 d=16 float32 " in out
    assert "FAIL" not in out
    rows = [json.loads(ln) for ln in jsonl.read_text().splitlines()]
    assert [r["tier"] for r in rows] == ["xla", "flash", "ring", "ulysses"]
    assert set(rows[0]) == ROW_KEYS
    assert set(rows[1]) == ROW_KEYS | {"k_tile_ceiling", "skip_tile_req"}
    assert set(rows[2]) == ROW_KEYS | {"k_tile_ceiling", "skip_tile_req",
                                       "ring_depth", "ring_tier"}
    assert all(r["tflops"] > 0 for r in rows)
    # the plain versions ran: no kernel launch is counted on the CPU
    assert hand.launch_counts() == before


def test_attnbench_stripe_requires_causal(capsys):
    rc = attnbench.main(ATTN_ARGS + ["--tiers", "ring", "--causal",
                                     "--stripe", "--k-tile", "32",
                                     "--skip-tile", "8"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "ATTN ring[striped] L=128 d=16 float32 " in out
    assert "FAIL" not in out
    with pytest.raises(SystemExit):
        attnbench.main(ATTN_ARGS + ["--tiers", "ring", "--stripe"])


def test_attnbench_refusals(capsys):
    assert attnbench.main(ATTN_ARGS + ["--tiers", "bogus"]) == 2
    assert "unknown tier" in capsys.readouterr().out
    # --ring-tier fused runs the fused kernel's plain version, tagged
    assert attnbench.main(ATTN_ARGS + ["--tiers", "ring", "--ring-tier",
                                       "fused"]) == 0
    assert "ATTN ring[fused] L=128 d=16 float32 " in capsys.readouterr().out
    with pytest.raises(TpuMtError, match="ROADMAP queue 1 item 17"):
        attnbench.main(ATTN_ARGS + ["--tune"])


def test_microbench_attention_groups_small(capsys):
    recs = microbench.run_groups(
        ["attention", "causal"], CPU,
        attention={"L": 64, "d": 16, "n_short": 2, "n_long": 12},
        causal={"sizes": ((64, "resident"), (96, "stream")), "d": 16,
                "iters": 10})
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert lines == recs
    assert [r["metric"] for r in recs] == [
        "attention_flash_float32_tflops", "attention_xla_float32_tflops",
        "attention_flash_bfloat16_tflops", "attention_xla_bfloat16_tflops",
        "attn_resident_full_bf16_L64", "attn_resident_causal_bf16_L64",
        "attn_resident_causal_decoupled_bf16_L64",
        "attn_stream_full_bf16_L96", "attn_stream_causal_bf16_L96",
        "attn_stream_causal_decoupled_bf16_L96"]
    for r in recs:
        assert math.isfinite(r["value"]) and r["value"] >= 0
        assert r["unit"] == ("TFLOP/s" if r["metric"].startswith(
            "attention_") else "ms/attn")
    assert "reads [" in recs[5]["detail"]


def test_microbench_attention_defaults_are_the_jax_sizes():
    import inspect

    sig = inspect.signature(microbench.bench_attention).parameters
    assert (sig["L"].default, sig["d"].default) == (8192, 128)
    assert (sig["n_short"].default, sig["n_long"].default) == (100, 1100)
    sig = inspect.signature(microbench.bench_causal).parameters
    assert sig["sizes"].default == ((8192, "resident"), (32768, "stream"))
    assert sig["d"].default == 128 and sig["iters"].default is None


def test_precision_context_restores_the_flag():
    before = torch.backends.cuda.matmul.allow_tf32
    with hand.matmul_precision("default"):
        assert torch.backends.cuda.matmul.allow_tf32
    with hand.matmul_precision("highest"):
        assert not torch.backends.cuda.matmul.allow_tf32
    assert torch.backends.cuda.matmul.allow_tf32 == before

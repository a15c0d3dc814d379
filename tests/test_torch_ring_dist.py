"""Attention over ranks on the CPU: ring attention (the torch-op and flash
tiers at depth 1, 2 and 4, contiguous and striped; the fused tier's plain
version), Ulysses attention (full, blockwise and flash forms) and the
all-to-all reshards, on gloo worlds of 2 and 4 ranks, held against the
JAX package on a 2- and 4-device mesh of conftest's fake devices, on the
same numpy inputs from a seed. One world per size is spawned for the
file (``tests/torch_dist_workers.py``, suite ``ring``).

Pairs and tolerances:

* ring attention, float32: port vs JAX's ``ring_attention_fn`` within
  ``atol 1e-5`` (JAX's own tier-swap gate, ``tests/test_ring.py:347``:
  the plain fold and the interpreted Pallas kernel sum in other orders);
  bfloat16 within ``atol 2e-2`` (outputs rounded to bfloat16, ~8e-3 at
  |x| < 2, and the XLA tier's scores rounded to bfloat16 on both sides,
  as ``tests/test_torch_attention.py``'s world=1 bfloat16 gate);
* depth 1, 2 and 4 of the port: bitwise (JAX's
  ``tests/test_overlap.py`` depth-invariance contract);
* the fused tier: its plain version against JAX's interpreted
  ``fused_ring_attention_pallas`` within ``1e-5``, and bitwise against
  the port's pipelined flash tier (float32 and bfloat16) and the
  one-process world simulation the card's cross-wired instances are held
  to (``hand.fused_ring_world_ref``);
* Ulysses: port vs ``ulysses_attention_fn`` within ``atol 1e-5``; the
  reshards bitwise against ``lax.all_to_all`` (``tiled=True``);
* ``attnbench`` at world 2: its lines and rows against the JAX driver's,
  the ``[fused]`` tag and the decline ``NOTE``.

The six red race contracts of ``tests/test_ring_sync.py`` (the simulated
interpreter's vector clocks) stay red on this image; the port is held to
the tests above, which pass, not to them.
"""

import functools
import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_dist_workers as W
from tpu_mpi_tests.comm import alltoall as JA
from tpu_mpi_tests.comm import ring as JR
from tpu_mpi_tests.comm.collectives import shard_1d
from tpu_mpi_tests.comm.mesh import make_mesh
from tpu_mpi_tests.compat import shard_map
from tpu_mpi_tests.drivers import attnbench as jattnbench
from tpu_mpi_tests.kernels import collectives_pallas as CP
from tpu_mpi_tests_torch.comm import dist
from tpu_mpi_tests_torch.comm.peer import PeerError
from tpu_mpi_tests_torch.kernels import hand

WORLDS = (2, 4)
ATOL = {"float32": 1e-5, "bfloat16": 2e-2}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return {w: W.spawn("ring", w, tmp_path_factory.mktemp(f"ring{w}"))
            for w in WORLDS}


@pytest.fixture(scope="module")
def meshes():
    return {w: make_mesh({"shard": w}, devices=jax.devices()[:w])
            for w in WORLDS}


def on_mesh(mesh, fn, arrs, dtype=jnp.float32):
    return np.asarray(fn(*(shard_1d(jnp.asarray(a, dtype), mesh)
                           for a in arrs)).astype(jnp.float32))


@functools.lru_cache(maxsize=None)
def jax_ring(w, flash, causal, stripe, dtype="float32", tier="pipelined"):
    mesh = make_mesh({"shard": w}, devices=jax.devices()[:w])
    fn = JR.ring_attention_fn(mesh, "shard", causal=causal, flash=flash,
                              interpret=True, stripe=stripe, depth=1,
                              tier=tier)
    return on_mesh(mesh, fn, W.ring_global(W.ring_seed(causal, stripe), w,
                                           stripe), getattr(jnp, dtype))


# ---------------------------------------------------------------------------
# ring attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("w", WORLDS)
@pytest.mark.parametrize("flash,causal,stripe,depth", W.RING_CASES)
def test_ring_tiers_match_jax(runs, w, flash, causal, stripe, depth):
    got = W.join(runs[w], W.ring_case(flash, causal, stripe, depth), w)
    want = jax_ring(w, flash, causal, stripe)
    assert got.shape == want.shape == (w * W.RING_L_LOCAL, W.RING_D)
    np.testing.assert_allclose(got, want, atol=ATOL["float32"], rtol=0)


@pytest.mark.parametrize("w", WORLDS)
@pytest.mark.parametrize("flash,causal,stripe", W.RING_LAYOUTS)
def test_ring_depth_is_bitwise_invariant(runs, w, flash, causal, stripe):
    one = W.join(runs[w], W.ring_case(flash, causal, stripe, 1), w)
    depths = [c[3] for c in W.RING_CASES if c[:3] == (flash, causal, stripe)]
    assert depths == [1, 2, 4]
    for depth in depths[1:]:
        assert np.array_equal(
            W.join(runs[w], W.ring_case(flash, causal, stripe, depth), w),
            one)


@pytest.mark.parametrize("w", WORLDS)
@pytest.mark.parametrize("flash", [False, True])
def test_ring_bfloat16_matches_jax(runs, w, flash):
    got = W.join(runs[w], W.ring_case(flash, True, False, 1, "bfloat16"), w)
    want = jax_ring(w, flash, True, False, "bfloat16")
    np.testing.assert_allclose(got, want, atol=ATOL["bfloat16"], rtol=0)


@pytest.mark.parametrize("w", WORLDS)
@pytest.mark.parametrize("causal,stripe", [(False, False), (True, False),
                                           (True, True)])
def test_fused_tier_matches_jax_interpreted_kernel(runs, w, causal, stripe):
    got = W.join(runs[w], f"fused_c{int(causal)}_s{int(stripe)}_float32", w)
    want = jax_ring(w, True, causal, stripe, tier="fused")
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("w", WORLDS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,stripe", [(False, False), (True, False),
                                           (True, True)])
def test_fused_tier_is_bitwise_the_pipelined_flash_tier(runs, w, dtype,
                                                        causal, stripe):
    tag = f"c{int(causal)}_s{int(stripe)}_{dtype}"
    fused = W.join(runs[w], f"fused_{tag}", w)
    assert np.array_equal(fused, W.join(runs[w], f"pipelined_{tag}", w))
    assert np.array_equal(fused, W.join(runs[w], f"fused_world_ref_{tag}",
                                        w))


# ---------------------------------------------------------------------------
# Ulysses and the reshards
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("w", WORLDS)
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("form,block_keys,flash", W.ULYSSES_FORMS)
def test_ulysses_forms_match_jax(runs, meshes, w, causal, form, block_keys,
                                 flash):
    heads = W.ULYSSES_HEADS_PER_RANK * w
    fn = JA.ulysses_attention_fn(meshes[w], "shard", causal=causal,
                                 block_keys=block_keys, flash=flash,
                                 interpret=True)
    want = on_mesh(meshes[w], fn, W.ring_global(600 + 10 * causal, w,
                                                heads=heads))
    got = W.join(runs[w], f"ulysses_{form}_c{int(causal)}", w)
    assert got.shape == (w * W.RING_L_LOCAL, heads, W.RING_D)
    np.testing.assert_allclose(got, want, atol=ATOL["float32"], rtol=0)


@pytest.mark.parametrize("w", WORLDS)
def test_reshards_equal_lax_all_to_all(runs, meshes, w):
    heads = W.ULYSSES_HEADS_PER_RANK * w
    x = W.ring_global(700, w, heads=heads)[0]
    run = jax.jit(functools.partial(
        shard_map, mesh=meshes[w], in_specs=P("shard"), out_specs=P("shard"),
        check_vma=False)(lambda t: JA.seq_to_heads(t, "shard")))
    want = np.asarray(run(shard_1d(jnp.asarray(x), meshes[w])))
    got = W.join(runs[w], "seq_to_heads", w)
    assert got.shape == (w * w * W.RING_L_LOCAL, heads // w, W.RING_D)
    assert np.array_equal(got, want)
    assert np.array_equal(W.join(runs[w], "heads_to_seq", w), x)
    bf16 = W.join(runs[w], "seq_to_heads_bf16", w)
    assert np.array_equal(bf16, torch.from_numpy(np.array(want)).to(torch.bfloat16)
                          .float().numpy())


@pytest.mark.parametrize("w", WORLDS)
def test_refusals_over_ranks(runs, w):
    for r in range(w):
        lines = W.read_text(runs[w], "errors", r).splitlines()
        assert len(lines) == 6, lines
        assert lines[0].startswith(f"MeshError: sequence-parallel attention "
                                   f"over world={w + 1} ranks requested, "
                                   f"but the process group has {w}")
        assert lines[1].startswith(f"MeshError: sequence-parallel attention "
                                   f"over world={2 * w} ranks")
        for line in lines[2:4]:
            assert line.startswith("ValueError: stripe=True only makes sense")
        assert "self_ring=2 is a single-device validation mode" in lines[4]
        assert f"{w + 1} not evenly divisible by {w}" in lines[5]


# ---------------------------------------------------------------------------
# attnbench at world 2, against the JAX driver
# ---------------------------------------------------------------------------

ATTN_RE = re.compile(r"^ATTN (\w+)((?:\[\w+\])*) L=(\d+) d=(\d+) (\w+) "
                     r"(\S+) TFLOP/s$")
COMPARED = ("kind", "tier", "L", "d", "dtype", "causal", "stripe", "world",
            "ring_depth", "ring_tier")


def jax_attnbench(monkeypatch, capsys, tmp_path, w, extra, feasible=True):
    real = jax.devices
    monkeypatch.setattr(jax, "devices", lambda *a, **k: real(*a, **k)[:w])
    if not feasible:
        monkeypatch.setattr(CP, "fused_ring_feasible",
                            lambda *a, **k: False)
    jsonl = tmp_path / "j.jsonl"
    capsys.readouterr()
    rc = jattnbench.main(["--seq-len", str(W.RING_L_LOCAL * w),
                          "--head-dim", str(W.RING_D), "--n-iter", "10",
                          "--jsonl", str(jsonl)] + extra)
    out = capsys.readouterr()
    monkeypatch.undo()
    # the JAX reference's chained timing of an interpreted kernel at this
    # toy size can difference to a non-positive time (a NaN row and its
    # FAIL line, rc 1); its lines and rows are still what is compared
    fails = [ln for ln in out.out.splitlines() if "FAIL" in ln]
    assert rc == (1 if fails else 0), out.out
    assert all("non-positive rate nan" in ln for ln in fails), out.out
    rows = [json.loads(ln) for ln in jsonl.read_text().splitlines()]
    return out, [r for r in rows if r.get("kind") == "attn"]


def port_rows(path):
    return [json.loads(ln) for ln in open(path).read().splitlines()]


def line_heads(text):
    return [m.groups()[:5] for m in (ATTN_RE.match(ln)
                                     for ln in text.splitlines()) if m]


@pytest.mark.parametrize("case,extra", [
    ("attnbench", ["--tiers", "ring,ulysses"]),
    ("attnbench_fused", ["--tiers", "ring,ulysses", "--ring-tier", "fused",
                         "--ring-depth", "2", "--causal", "--stripe"])])
def test_attnbench_world2_lines_and_rows_equal_jax(runs, monkeypatch, capsys,
                                                   tmp_path, case, extra):
    out, jrows = jax_attnbench(monkeypatch, capsys, tmp_path, 2, extra)
    jfile = "a" if case == "attnbench" else "f"
    for r in range(2):
        text = W.read_text(runs[2], case, r)
        assert text.startswith("RC 0\n"), text
        assert line_heads(text) == line_heads(out.out)
        assert "NOTE" not in text and "FAIL" not in text
        rows = port_rows(f"{runs[2]}/{jfile}.p{r}.jsonl")
        assert [{k: row.get(k) for k in COMPARED} for row in rows] == \
            [{k: row.get(k) for k in COMPARED} for row in jrows]
        assert all(row["tflops"] > 0 for row in rows)
    if case == "attnbench_fused":
        assert line_heads(out.out)[0][:2] == ("ring", "[striped][fused]")
        assert jrows[0]["ring_tier"] == "fused"
        assert jrows[0]["ring_depth"] == 2


def test_attnbench_world2_declines_fused_with_the_jax_note(
        runs, monkeypatch, capsys, tmp_path):
    out, jrows = jax_attnbench(monkeypatch, capsys, tmp_path, 2,
                               ["--tiers", "ring", "--ring-tier", "fused"],
                               feasible=False)
    note = re.compile(r"^NOTE ring tier fused infeasible at lq=16 d=16 "
                      r"float32 \(.*\); running the pipelined tier$",
                      re.MULTILINE)
    assert note.search(out.err)
    assert jrows[0]["ring_tier"] == "pipelined"
    for r in range(2):
        text = W.read_text(runs[2], "attnbench_declined", r)
        assert text.startswith("RC 0\n"), text
        assert line_heads(text) == line_heads(out.out) == [
            ("ring", "", "32", "16", "float32")]
        assert note.search(text.split("ERR\n", 1)[1])


# ---------------------------------------------------------------------------
# the gate and the refusals at world=1
# ---------------------------------------------------------------------------


def test_fused_gate_is_the_cards_not_the_tpus(monkeypatch):
    # JAX declines (8192, 8192, 128) f32 (its 14 MiB VMEM model); the CUDA
    # kernel streams tiles through shared memory and runs it
    assert not CP.fused_ring_feasible(8192, 8192, 128, np.float32)
    assert hand.fused_ring_feasible(8192, 8192, 128, torch.float32)
    assert hand.fused_ring_feasible(8192, 8192, 256, torch.bfloat16)
    assert not hand.fused_ring_feasible(64, 64, 257, torch.float32)
    assert not hand.fused_ring_feasible(64, 64, 16, torch.float64)
    assert not hand.fused_ring_feasible(0, 64, 16, torch.float32)
    # on more than one rank the comm slots must fit the card's free memory
    monkeypatch.setattr(dist, "world", lambda: dist.World(
        rank=0, size=2, local_rank=0, device=torch.device("cpu"),
        backend="gloo"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    need = 4 * hand.fused_ring_slot_offset(64, 16, 4)
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda dev=None: (need - 1, 10**12))
    assert not hand.fused_ring_feasible(64, 64, 16, torch.float32)
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda dev=None: (need, 10**12))
    assert hand.fused_ring_feasible(64, 64, 16, torch.float32)
    # one rank forwards nothing: no memory rule
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda dev=None: (0, 10**12))
    assert not hand.fused_ring_feasible(64, 64, 16, torch.float32)
    monkeypatch.setattr(dist, "world", lambda: dist.World(
        rank=0, size=1, local_rank=0, device=torch.device("cpu"),
        backend=None))
    assert hand.fused_ring_feasible(64, 64, 16, torch.float32)


def test_fused_slot_offset_rounds_to_16_bytes():
    assert hand.fused_ring_slot_offset(4, 3, 4) == 48
    assert hand.fused_ring_slot_offset(3, 3, 2) == 32
    assert hand.fused_ring_slot_offset(8192, 128, 4) == 8192 * 128 * 4


def test_fused_refuses_nine_ranks_and_a_bad_layout(monkeypatch):
    q = torch.zeros(16, 8)
    with pytest.raises(PeerError, match="serve at most 8"):
        hand.fused_ring_attention(q, q, q, self_ring=9)
    with pytest.raises(ValueError, match="stripe=True only"):
        hand.fused_ring_attention(q, q, q, stripe=True)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        hand.fused_ring_attention(q.double(), q.double(), q.double())
    monkeypatch.setattr(dist, "world", lambda: dist.World(
        rank=0, size=9, local_rank=0, device=torch.device("cpu"),
        backend="gloo"))
    assert not hand.fused_ring_feasible(16, 16, 8, torch.float32)
    with pytest.raises(PeerError, match="9 ranks"):
        hand.fused_ring_attention(q, q, q)


@pytest.mark.parametrize("k", [2, 4, 8])
@pytest.mark.parametrize("causal,stripe", [(False, False), (True, False),
                                           (True, True)])
def test_fused_self_ring_is_the_world_simulation(k, causal, stripe):
    rng = np.random.default_rng(40 + k)
    q, kk, v = (torch.from_numpy(rng.normal(size=(24, 8)).astype(np.float32))
                for _ in range(3))
    got = hand.fused_ring_attention(q, kk, v, causal=causal, stripe=stripe,
                                    self_ring=k)
    want = hand.fused_ring_world_ref([(q, kk, v)] * k, causal=causal,
                                     stripe=stripe)[0]
    assert torch.equal(got, want)
    assert hand.fused_ring_attention.launches == 0  # the plain version ran

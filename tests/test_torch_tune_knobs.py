"""The knob owners outside the stencil path (``coll_variant/*``,
``ring/pipeline_depth``, ``ring/tier``, ``daxpy/chunk``), on the CPU,
and the dispatch window's depth (``coll/dispatch_depth``): every resolver's
precedence (explicit > cached > prior) and its degrade (a malformed
cached value gives the prior; a cached ``fused`` the gate declines runs
pipelined, with a NOTE), held against the JAX resolvers where both have
one; and the tuned runs against the JAX package's results for the same
seeds. The fleet path (rank 0 sweeps, every rank applies) is in
``tests/test_torch_tune_dist.py``.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from tpu_mpi_tests.comm import collectives as JC
from tpu_mpi_tests.comm import ring as JR
from tpu_mpi_tests.drivers import daxpy as jdaxpy
from tpu_mpi_tests.tune import registry as jreg
from tpu_mpi_tests_torch.comm import collectives as C
from tpu_mpi_tests_torch.comm import ring as TR
from tpu_mpi_tests_torch.drivers import attnbench, collbench
from tpu_mpi_tests_torch.kernels import hand
from tpu_mpi_tests_torch.tune import priors
from tpu_mpi_tests_torch.tune import registry as treg
from tpu_mpi_tests_torch.tune.fingerprint import (
    device_fingerprint,
    fingerprint,
)
from tpu_mpi_tests_torch.workloads import daxpy

CPU = ["--device", "cpu"]


@pytest.fixture
def cache(tmp_path):
    """A configured, empty schedule cache (deconfigured after)."""
    c = treg.configure(cache_path=str(tmp_path / "tune.json"))
    yield c
    treg.deconfigure()


def _store(c, knob, value, **ctx):
    c.store(knob, fingerprint(**ctx) if ctx else device_fingerprint(),
            value)


#: (knob, resolver(explicit), context the resolver keys by, explicit,
#: cached, prior, malformed)
RESOLVERS = {
    "ring/pipeline_depth": (
        lambda e: TR.resolve_pipeline_depth(e, dtype=torch.float32, lq=64),
        {"dtype": "float32", "lq": 64}, 4, 2, 1, [1]),
    "ring/tier": (
        lambda e: TR.resolve_ring_tier(e, dtype=torch.float32, lq=64, d=16),
        {"dtype": "float32", "lq": 64}, "pipelined", "fused", "pipelined",
        "ring"),
}


@pytest.mark.parametrize("knob", sorted(RESOLVERS))
def test_resolver_precedence_and_degrade(cache, knob):
    fn, ctx, explicit, cached, prior, malformed = RESOLVERS[knob]
    assert fn(None) == prior  # an empty cache: the prior
    _store(cache, knob, cached, **ctx)
    assert fn(None) == cached
    assert fn(explicit) == explicit
    _store(cache, knob, malformed, **ctx)
    assert fn(None) == prior


@pytest.mark.parametrize("v", [None, 2, 4, "8", "x", 0])
def test_dispatch_depth_has_no_space_and_matches_jax(cache, v):
    """The ``coll/dispatch_depth`` space is the JAX package's (its reader
    is the serve halo handler): an empty cache resolves every explicit
    value as the JAX resolver does, and a cached depth moves the window
    (explicit > cached > prior, the device-only fallback on)."""
    assert treg.space("coll/dispatch_depth").candidates == \
        jreg.space("coll/dispatch_depth").candidates == (1, 2, 4, 8)
    assert C.resolve_dispatch_depth(v) == JC.resolve_dispatch_depth(v)
    assert C.DispatchWindow().depth == priors.COLL_DISPATCH_DEPTH == 1
    _store(cache, "coll/dispatch_depth", 8)  # the device-only entry
    want = 8 if v is None else JC.resolve_dispatch_depth(v)
    assert C.resolve_dispatch_depth(v, dtype="float32", n=64, world=1) \
        == want
    assert C.DispatchWindow(v, dtype="float32", n=64, world=1).depth \
        == want


def test_cached_fused_degrades_where_the_gate_declines(cache, monkeypatch,
                                                       capsys):
    _store(cache, "ring/tier", "fused", dtype="float32", lq=16)
    monkeypatch.setattr(hand, "fused_ring_feasible", lambda *a, **k: False)
    assert TR.resolve_ring_tier(None, dtype=torch.float32, lq=16,
                                d=16) == "pipelined"
    assert re.search(r"^NOTE cached ring/tier fused infeasible at lq=16 "
                     r"d=16 float32 .*running the pipelined tier$",
                     capsys.readouterr().err, re.M)
    # an explicit fused stays as asked (the kernel's gate raises)
    assert TR.resolve_ring_tier("fused", dtype=torch.float32, lq=16,
                                d=16) == "fused"


def test_coll_variant_precedence_refusal_and_spaces(cache, capsys):
    import argparse

    a = argparse.Namespace(dtype="float32", rdma_credits=1, n_iter=10)
    ctx = {"dtype": "float32", "bytes": 4096, "world": 1}

    def resolve():
        return collbench.resolve_variant("allreduce", a, 1, 0, 1024,
                                         torch.float32, torch.device("cpu"),
                                         4096)

    assert resolve() == "allreduce"  # the prior: the library tier
    for cached, want in (("oneshot", "allreduce_oneshot"),
                         ("rdma", "allreduce_rdma"),
                         ("xla", "allreduce"), ([1], "allreduce")):
        _store(cache, "coll_variant/allreduce", cached, **ctx)
        assert resolve() == want
    # the spaces are the JAX package's, the library tier named "torch"
    for base, sp in collbench.COLL_VARIANT_SPACES.items():
        assert sp.candidates == ("torch", "rdma", "oneshot")
        assert jreg.space(f"coll_variant/{base}").candidates == (
            "xla", "rdma", "oneshot")
    # a variant a world cannot run is declined with its reason
    assert collbench.variant_refusal("allreduce_rdma", 1001, 1) is None
    assert collbench.variant_refusal("allgather", 1001, 9) is None
    assert "at most 8" in collbench.variant_refusal("allgather_oneshot",
                                                    1024, 9)


def test_declined_candidate_never_wins(cache, monkeypatch, capsys):
    import argparse

    treg.configure(cache_path=cache.path, enabled=True)
    a = argparse.Namespace(dtype="float32", rdma_credits=1, n_iter=10)
    monkeypatch.setattr(collbench, "variant_refusal",
                        lambda name, n, w: "refused here"
                        if name.endswith("_rdma") else None)
    recs = []
    treg.set_emit(recs.append)
    got = collbench.resolve_variant("allgather", a, 1, 0, 1024,
                                    torch.float32, torch.device("cpu"), 4096)
    declined = [r for r in recs if r["kind"] == "tune"
                and r["candidate"] == "rdma"]
    assert declined and "refused here" in declined[0]["error"]
    assert declined[0]["seconds"] is None
    result = [r for r in recs if r["kind"] == "tune_result"][0]
    assert result["value"] != "rdma" and got != "allgather_rdma"
    treg.deconfigure()


@pytest.mark.parametrize("cached,phases", [(None, 64), (8, 8), (32, 2),
                                          ("x", 64)])
def test_daxpy_chunk_cached_prior_and_malformed(tmp_path, capsys, cached,
                                                phases):
    import json

    path = tmp_path / "tune.json"
    if cached is not None:
        c = treg.configure(cache_path=str(path))
        _store(c, "daxpy/chunk", cached, n=4096, dtype="float32")
        c.save()
        treg.deconfigure()
    argv = CPU + ["--n", "4096", "--iters", "64", "--verbose",
                  "--tune-cache", str(path), "--jsonl",
                  str(tmp_path / "d.jsonl")]
    try:
        assert daxpy.main(argv) == 0
    finally:
        treg.deconfigure()
    out = capsys.readouterr().out
    assert "0/1 SUM = 8390656.000000" in out
    assert re.search(rf"^TIME kernel : \S+ count={phases} ", out, re.M)
    recs = [json.loads(ln) for ln in
            (tmp_path / "d.jsonl").read_text().splitlines()]
    assert [r for r in recs if r["kind"] == "time"
            and r["phase"] == "kernel"][0]["count"] == phases


def test_tuned_daxpy_gives_the_jax_checksum(tmp_path, capsys):
    cache = str(tmp_path / "tune.json")
    try:
        assert daxpy.main(CPU + ["--n", "4096", "--iters", "64", "--tune",
                                 "--tune-cache", cache]) == 0
        out = capsys.readouterr().out
        assert "TUNE daxpy/chunk winner=" in out
        assert daxpy.main(CPU + ["--n", "4096", "--iters", "64", "--tune",
                                 "--tune-cache", cache]) == 0
        hit = capsys.readouterr().out
        assert "TUNE daxpy/chunk cache-hit" in hit
    finally:
        treg.deconfigure()
    assert jdaxpy.main(["--n", "4096", "--iters", "64"]) == 0
    jout = capsys.readouterr().out
    want = re.search(r"^\d+/\d+ SUM = .*$", jout, re.M).group(0)
    assert want in out and want in hit


@pytest.mark.parametrize("causal,stripe", [(False, False), (True, False),
                                           (True, True)])
def test_tuned_ring_gives_the_jax_result(cache, causal, stripe):
    """The cached depth and tier (the JAX package's explicit twins)
    change the schedule, never the result."""
    rng = np.random.default_rng(7)
    q, k, v = (rng.normal(size=(128, 32)).astype(np.float32)
               for _ in range(3))
    mesh1 = Mesh(np.array(jax.devices()[:1]), ("shard",))
    ctx = {"dtype": "float32", "lq": 128}
    want = None
    for depth, tier in ((2, "pipelined"), (4, "fused")):
        _store(cache, "ring/pipeline_depth", depth, **ctx)
        _store(cache, "ring/tier", tier, **ctx)
        got = TR.ring_attention_fn(1, causal=causal, flash=True,
                                   stripe=stripe)(
            *(torch.from_numpy(a) for a in (q, k, v))).numpy()
        jattn = JR.ring_attention_fn(mesh1, "shard", causal=causal,
                                     flash=True, stripe=stripe,
                                     interpret=True, depth=depth, tier=tier)
        want = np.asarray(jattn(*(jnp.asarray(a) for a in (q, k, v))))
        np.testing.assert_allclose(got, want, atol=5e-5)


def test_attnbench_rows_name_the_cached_schedule(cache, tmp_path, capsys):
    import json

    _store(cache, "ring/pipeline_depth", 2, dtype="float32", lq=64)
    _store(cache, "ring/tier", "fused", dtype="float32", lq=64)
    cache.save()
    jl = tmp_path / "a.jsonl"
    assert attnbench.main(CPU + ["--tiers", "ring", "--seq-len", "64",
                                 "--head-dim", "16", "--n-iter", "20",
                                 "--tune-cache", str(cache.path),
                                 "--jsonl", str(jl)]) == 0
    assert "ATTN ring[fused] L=64 d=16 float32 " in capsys.readouterr().out
    row = [json.loads(ln) for ln in jl.read_text().splitlines()
           if json.loads(ln)["kind"] == "attn"][0]
    assert row["ring_depth"] == 2 and row["ring_tier"] == "fused"

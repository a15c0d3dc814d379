"""The port's schedule plane (``tpu_mpi_tests_torch/tune/``) held against
the JAX package's (``tpu_mpi_tests/tune/``) on the CPU.

* the cache: a file either package writes, the other reads, entry for
  entry; a corrupt, foreign or stale-version file loads as empty in both;
  one file holds both packages' entries and neither resolves the other's;
* the fingerprint: ``shape_bucket`` and ``compose`` equal over their
  domains; the port's fingerprints never equal a TPU's or the JAX
  package's own;
* precedence: explicit > cached > prior at every resolver of
  ``comm/halo.py`` in both packages, each with an entry under its own
  fingerprint; a malformed cached value gives the prior in both;
* the sweep: the same stubbed, deterministic ``measure`` picks the same
  winner in both, with the same records (the fingerprint aside), and
  stops at the budget alike; the JAX report CLI reads the port's records;
* packs: ``make_pack`` / ``merge_entries`` / ``absorb`` give equal
  documents and conflicts, and the ``python -m`` CLI round-trips a cache.
"""

import importlib
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from tpu_mpi_tests.comm import halo as JH
from tpu_mpi_tests.tune import pack as jpack
from tpu_mpi_tests.tune import registry as jreg
from tpu_mpi_tests.tune.cache import CACHE_VERSION as JAX_CACHE_VERSION
from tpu_mpi_tests.tune.cache import ScheduleCache as JaxCache
from tpu_mpi_tests.tune import fingerprint as jfp
from tpu_mpi_tests_torch.comm import halo as TH
from tpu_mpi_tests_torch.tune import cache as tcache
from tpu_mpi_tests_torch.tune import fingerprint as tfp
from tpu_mpi_tests_torch.tune import fleet as tfleet
from tpu_mpi_tests_torch.tune import pack as tpack
from tpu_mpi_tests_torch.tune import priors as tpriors
from tpu_mpi_tests_torch.tune import registry as treg

# the packages export their ``sweep`` function under the module's name
jsweep = importlib.import_module("tpu_mpi_tests.tune.sweep")
tsweep = importlib.import_module("tpu_mpi_tests_torch.tune.sweep")
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    """Both registries start and end unconfigured; no real cache file
    leaks in."""
    monkeypatch.delenv("TPU_MPI_TUNE_CACHE", raising=False)
    treg.deconfigure()
    jreg.deconfigure()
    yield
    treg.deconfigure()
    jreg.deconfigure()


# ---------------------------------------------------------------- cache


def _entries(c):
    return {k: (v["value"], v["seconds"], v["knob"], v["fingerprint"])
            for k, v in c.entries.items()}


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_cache_round_trip_between_packages(tmp_path, writer):
    path = str(tmp_path / "tune.json")
    w_cls, r_cls = ((JaxCache, tcache.ScheduleCache) if writer == "jax"
                    else (tcache.ScheduleCache, JaxCache))
    c = w_cls.load(path)
    assert len(c) == 0  # a missing file is empty, without an error
    c.store("halo/staging", "fp1", "device", seconds=0.25)
    c.store("stencil/tier", "fp2", "rdma-chained", seconds=0.5)
    c.store("flash_tiles/contig", "fp3", {"k_tile": 1024, "skip_tile": 0})
    c.save()
    r = r_cls.load(path)
    assert _entries(r) == _entries(c)
    assert r.lookup("stencil/tier", "fp2") == "rdma-chained"
    assert r.lookup("flash_tiles/contig", "fp3") == {"k_tile": 1024,
                                                     "skip_tile": 0}
    assert r.lookup("halo/staging", "other") is None
    doc = json.loads(Path(path).read_text())
    assert doc["version"] == tcache.CACHE_VERSION == JAX_CACHE_VERSION
    # merge-on-write: the reader's own entry joins the writer's
    r.store("halo/overlap", "fp4", 2)
    r.save()
    both = w_cls.load(path)
    assert len(both) == 4 and both.lookup("halo/overlap", "fp4") == 2


@pytest.mark.parametrize("content", [
    "not json at all{{{",
    '{"version": 999, "entries": {"k|f": {"value": 7}}}',
    "[1, 2, 3]",
    '{"version": 1, "entries": "not-a-dict"}',
    '{"entries": {"k|f": {"value": 7}}}',
])
def test_corrupt_or_stale_cache_loads_empty_in_both(tmp_path, content,
                                                    capsys):
    path = tmp_path / "tune.json"
    path.write_text(content)
    assert len(JaxCache.load(str(path))) == 0
    assert len(tcache.ScheduleCache.load(str(path))) == 0
    assert "NOTE tune cache" in capsys.readouterr().err
    # configured but unusable: every resolver gives its prior
    treg.configure(cache_path=str(path))
    assert TH.resolve_stencil_tier(None, dtype="float32", n=64,
                                   world=1) == tpriors.STENCIL_TIER["float32"]
    assert TH.resolve_overlap_depth(None, dtype="float32") == 1


def test_cache_paths_and_read_only_writer(tmp_path, monkeypatch):
    monkeypatch.setenv("TPU_MPI_TUNE_CACHE", str(tmp_path / "x.json"))
    from tpu_mpi_tests.tune.cache import default_cache_path

    assert tcache.default_cache_path() == default_cache_path()
    monkeypatch.delenv("TPU_MPI_TUNE_CACHE")
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg"))
    assert tcache.default_cache_path() == default_cache_path() == str(
        tmp_path / "xdg" / "tpumt" / "tune.json")
    c = tcache.ScheduleCache.load(str(tmp_path / "ro.json"))
    c.read_only = True
    c.store("k", "f", 1)
    c.save()
    assert not (tmp_path / "ro.json").exists()


# ---------------------------------------------------------- fingerprint


def test_shape_bucket_equal_over_its_domain():
    values = list(range(0, 4097)) + [
        (1 << e) + d for e in range(12, 31) for d in (-1, 0, 1)]
    for v in values:
        assert tfp.shape_bucket(v) == jfp.shape_bucket(v), v
    assert tfp.shape_bucket(1 << 30) == 1 << 30


@pytest.mark.parametrize("base,ctx", [
    (None, {}),
    ({"platform": "gpu", "device": "NVIDIA H100 80GB HBM3"},
     {"dtype": "float32", "n": 8192, "world": 1}),
    ({"b": "1", "a": "2"}, {"extent": 8193, "lq": 100, "bytes": 5,
                            "shape": 3, "label": "x", "none": None}),
    ({}, {"n": "8193", "world": 4}),
])
def test_compose_equal_in_both(base, ctx):
    assert tfp.compose(base, **ctx) == jfp.compose(base, **ctx)


def test_port_fingerprint_is_its_own(monkeypatch):
    fields = dict(tfp.device_fields())
    assert fields == {"platform": "cpu", "device": "cpu", "ndev": "1",
                      "procs": "1", "stack": "torch"}
    assert tfp.topology_label() == "flat"
    tpu = {"platform": "tpu", "device": "TPU v5 lite", "ndev": "1",
           "procs": "1"}
    for ctx in ({}, {"dtype": "float32", "n": 8192, "world": 1}):
        port = tfp.fingerprint(**ctx)
        assert port != jfp.compose(tpu, **ctx)
        assert port != jfp.fingerprint(**ctx)
        # the same fields compose the same string in both packages
        monkeypatch.setattr(jfp, "device_fields",
                            lambda: tuple(sorted(fields.items())))
        assert jfp.fingerprint(**ctx) == port
        monkeypatch.undo()
    assert tfp.device_fingerprint() == tfp.compose(fields)


# ---------------------------------------------------------- precedence


def _both_caches(tmp_path):
    """One cache file configured in both registries."""
    path = str(tmp_path / "tune.json")
    return treg.configure(cache_path=path), jreg.configure(cache_path=path)


def test_precedence_at_the_stencil_resolvers(tmp_path):
    tc, jc = _both_caches(tmp_path)
    ctx = {"dtype": "float32", "n": 8192, "world": 1}
    # prior: each package's own table
    assert TH.resolve_stencil_tier(None, **ctx) == \
        tpriors.STENCIL_TIER["float32"]
    assert JH.resolve_stencil_tier(None, **ctx) == "blocks"
    # cached beats prior, each under its own fingerprint
    tc.store("stencil/tier", tfp.fingerprint(**ctx), "xla")
    assert TH.resolve_stencil_tier(None, **ctx) == "xla"
    assert JH.resolve_stencil_tier(None, **ctx) == "blocks"  # not JAX's
    jc.store("stencil/tier", jfp.fingerprint(**ctx), "xla")
    assert JH.resolve_stencil_tier(None, **ctx) == "xla"
    # explicit beats cached
    for tier in TH.STENCIL_TIERS:
        assert TH.resolve_stencil_tier(tier, **ctx) == \
            JH.resolve_stencil_tier(tier, **ctx) == tier
    # another context's winner never leaks (no device-only fallback)
    assert TH.resolve_stencil_tier(None, dtype="bfloat16", n=8192,
                                   world=1) == tpriors.STENCIL_TIER[
                                       "bfloat16"]
    # malformed cached values give the prior in both
    tc.store("stencil/tier", tfp.fingerprint(**ctx), "bogus")
    jc.store("stencil/tier", jfp.fingerprint(**ctx), "bogus")
    assert TH.resolve_stencil_tier(None, **ctx) == \
        tpriors.STENCIL_TIER["float32"]
    assert JH.resolve_stencil_tier(None, **ctx) == "blocks"
    # the block count and the depth: explicit > cached > prior
    assert TH.resolve_stencil_blocks(None, **ctx) == tpriors.BENCH_BLOCKS[
        "float32"]
    tc.store("stencil/blocks", tfp.fingerprint(**ctx), 4)
    assert TH.resolve_stencil_blocks(None, **ctx) == 4
    assert TH.resolve_stencil_blocks(2, **ctx) == 2
    tc.store("stencil/blocks", tfp.fingerprint(**ctx), "x")
    assert TH.resolve_stencil_blocks(None, **ctx) == tpriors.BENCH_BLOCKS[
        "float32"]
    assert TH.resolve_stencil_steps(None, n=8192, world=1) == \
        tpriors.BENCH_STEPS
    tc.store("stencil/steps", tfp.fingerprint(n=8192, world=1), 2)
    assert TH.resolve_stencil_steps(None, n=8192, world=1) == 2
    assert TH.resolve_stencil_steps(4, n=8192, world=1) == 4


def test_precedence_at_the_overlap_resolver(tmp_path):
    tc, jc = _both_caches(tmp_path)
    ctx = {"dtype": "float64", "n": 4096, "world": 1}
    assert TH.resolve_overlap_depth(None, **ctx) == \
        JH.resolve_overlap_depth(None, **ctx) == 1
    tc.store("halo/overlap", tfp.fingerprint(**ctx), 2)
    jc.store("halo/overlap", jfp.fingerprint(**ctx), 2)
    assert TH.resolve_overlap_depth(None, **ctx) == \
        JH.resolve_overlap_depth(None, **ctx) == 2
    assert TH.resolve_overlap_depth(1, **ctx) == \
        JH.resolve_overlap_depth(1, **ctx) == 1
    for bad in ("x", None, [2], 7):
        tc.store("halo/overlap", tfp.fingerprint(**ctx), bad)
        jc.store("halo/overlap", jfp.fingerprint(**ctx), bad)
        assert TH.resolve_overlap_depth(None, **ctx) == \
            JH.resolve_overlap_depth(None, **ctx), bad


class _GlobalZg:
    """The JAX package's global array, as its staging context sees it."""

    shape = (1024, 64)
    dtype = "float32"


def test_precedence_at_the_staging_resolver(tmp_path):
    tc, jc = _both_caches(tmp_path)
    world = 2
    local = torch.zeros((512, 64))  # a rank's block of the same array
    assert TH._staging_context(local, 0, world) == \
        JH._staging_context(_GlobalZg(), 0, world)
    tctx = TH._staging_context(local, 0, world)
    jctx = JH._staging_context(_GlobalZg(), 0, world)
    assert TH.resolve_staging("auto", local, 0, world) is TH.Staging.DIRECT
    assert JH.resolve_staging("auto", _GlobalZg(), 0, world) is \
        JH.Staging.DIRECT
    for val, want in (("device", "device"), ("pallas", "pallas"),
                      ("host", "direct"), ("auto", "direct"),
                      ("bogus", "direct")):
        tc.store("halo/staging", tfp.fingerprint(**tctx), val)
        jc.store("halo/staging", jfp.fingerprint(**jctx), val)
        assert TH.resolve_staging("auto", local, 0, world).value == \
            JH.resolve_staging("auto", _GlobalZg(), 0, world).value == want
    # explicit never consults the cache
    assert TH.resolve_staging("direct", local, 0, world) is \
        TH.Staging.DIRECT
    # and halo_exchange resolves it: device staging on the cached entry
    tc.store("halo/staging", tfp.fingerprint(
        **TH._staging_context(torch.zeros((12, 5)), 0, 1)), "device")
    z = torch.arange(60.0).reshape(12, 5)
    want = TH.halo_exchange(z.clone(), 0, 2, True, "device")
    got = TH.halo_exchange(z.clone(), 0, 2, True, "auto")
    assert torch.equal(got, want)


def test_rdma_winner_degrades_where_rdma_cannot_run(tmp_path, monkeypatch,
                                                    capsys):
    tc, _ = _both_caches(tmp_path)
    ctx = {"dtype": "float32", "n": 64, "world": 1}
    tc.store("stencil/tier", tfp.fingerprint(**ctx), "rdma-fused")
    assert TH.resolve_stencil_tier(None, **ctx) == "rdma-fused"
    monkeypatch.setattr(TH, "rdma_refusal", lambda: "2 hosts")
    assert TH.resolve_stencil_tier(None, **ctx) == \
        tpriors.STENCIL_TIER_NO_RDMA
    assert "NOTE stencil/tier rdma-fused cannot run here (2 hosts); " \
        "resolved -> blocks" in capsys.readouterr().err
    # an explicit tier is never changed
    assert TH.resolve_stencil_tier("rdma-fused", **ctx) == "rdma-fused"


def test_spaces_and_priors():
    sp = treg.spaces()
    # every space the JAX package declares, but the MoE and embedding
    # knobs (their modules are not ported), the flash tiles (the CUDA
    # fold takes no tile argument) and the dispatch depth (its reader,
    # the serve halo handler, is not ported)
    assert set(sp) == set(jreg.spaces()) - {
        "moe/combine", "embedding/lookup", "flash_tiles/contig",
        "flash_tiles/striped", "coll/dispatch_depth"}
    for knob, space in sp.items():
        # the library tier is "torch" where the JAX package says "xla"
        jc = ["torch" if c == "xla" and knob.startswith("coll_variant/")
              else c for c in jreg.space(knob).candidates]
        assert all(c in jc + ["xla", "direct"] for c in space.candidates), \
            knob
        assert len(set(space.candidates)) == len(space.candidates)
    assert TH.stencil_tier_candidates("bfloat16")[0] == \
        tpriors.stencil_tier("bfloat16")
    assert set(TH.stencil_tier_candidates("float32")) == set(
        JH.STENCIL_TIER_SPACE.candidates)
    assert TH.stencil_blocks_candidates("bfloat16")[0] == \
        tpriors.bench_blocks("bfloat16")
    assert treg.preload() == {k: s.prior for k, s in sp.items()}


# ---------------------------------------------------------------- sweep


def _strip(recs):
    return [{k: v for k, v in r.items() if k != "fingerprint"}
            for r in recs]


def _sweep_both(tmp_path, fn, *args, **kw):
    """Run ``fn`` of each package (``sweep`` or ``ensure_tuned``) with
    the same arguments on its own configured cache."""
    out = {}
    for name, reg, mod in (("port", treg, tsweep), ("jax", jreg, jsweep)):
        reg.configure(cache_path=str(tmp_path / f"{name}.json"),
                      enabled=True, budget_s=60.0)
        recs = []
        value = getattr(mod, fn)(*args, emit=recs.append, **kw)
        out[name] = (value, recs)
    return out


timings = {"a": 0.5, "b": 0.125, "c": 0.25}


def test_sweep_same_winner_and_records(tmp_path):
    out = _sweep_both(tmp_path, "sweep", "demo/knob",
                      lambda c: timings[c], candidates=("a", "b", "c"),
                      dtype="float32", lq=128)
    assert out["port"][0] == out["jax"][0] == "b"
    assert _strip(out["port"][1]) == _strip(out["jax"][1])
    assert [r["kind"] for r in out["port"][1]] == ["tune"] * 3 + [
        "tune_result"]
    port = tcache.ScheduleCache.load(str(tmp_path / "port.json"))
    assert port.lookup("demo/knob", tfp.fingerprint(
        dtype="float32", lq=128)) == "b"
    assert port.lookup("demo/knob", tfp.device_fingerprint()) == "b"


def test_sweep_budget_declines_and_invalid_alike(tmp_path):
    out = _sweep_both(tmp_path, "sweep", "demo/knob2", lambda c: 1.0,
                      candidates=("prior", "x", "y"), budget_s=0.0)
    assert out["port"][0] == out["jax"][0] == "prior"
    assert _strip(out["port"][1]) == _strip(out["jax"][1])
    assert out["port"][1][-1]["skipped"] == 2

    def measure(cand):
        if cand == "bad":
            raise ValueError("no block fits")
        return 1.0

    out = _sweep_both(tmp_path, "sweep", "demo/knob3", measure,
                      candidates=("bad", "ok"))
    assert out["port"][0] == out["jax"][0] == "ok"
    assert _strip(out["port"][1]) == _strip(out["jax"][1])
    assert out["port"][1][0]["error"] == "ValueError: no block fits"
    out = _sweep_both(tmp_path, "sweep", "demo/knob4",
                      lambda c: float("nan"), candidates=("p", "q"))
    assert out["port"][0] == out["jax"][0] == "p"
    assert _strip(out["port"][1]) == _strip(out["jax"][1])


def test_ensure_tuned_hit_and_prior_alike(tmp_path):
    calls = []

    def measure(cand):
        calls.append(cand)
        return {"slow": 1.0, "fast": 0.5}[cand]

    first = _sweep_both(tmp_path, "ensure_tuned", "demo/knob5", measure,
                        candidates=("slow", "fast"), dtype="float32")
    assert first["port"][0] == first["jax"][0] == "fast"
    assert calls == ["slow", "fast"] * 2
    calls.clear()
    again = _sweep_both(tmp_path, "ensure_tuned", "demo/knob5", measure,
                        candidates=("slow", "fast"), dtype="float32")
    assert calls == []
    assert _strip(again["port"][1]) == _strip(again["jax"][1]) == [
        {"kind": "tune_hit", "knob": "demo/knob5", "value": "fast"}]
    for reg, mod in ((treg, tsweep), (jreg, jsweep)):
        reg.configure(cache_path=str(tmp_path / "off.json"))
        assert mod.ensure_tuned("demo/knob6",
                                lambda c: pytest.fail("measured"),
                                candidates=("p", "q"), prior="p") == "p"
        assert mod.ensure_tuned("demo/knob6", None, explicit="q") == "q"


def test_feedback_rate_on_the_cpu():
    sec, state = tsweep.feedback_rate(lambda z: z + 1.0, torch.zeros(4))
    assert state[0] == 3 + 4 + 12 and (sec != sec or sec > 0)


def test_jax_report_reads_the_port_records(tmp_path):
    from tpu_mpi_tests.instrument.aggregate import summarize

    recs = []
    treg.configure(cache_path=str(tmp_path / "t.json"), enabled=True)
    tsweep.sweep("halo/staging", lambda c: {"direct": 2e-4,
                                            "device": 1e-4}[c],
                 candidates=("direct", "device", "pallas"),
                 emit=recs.append)
    f = tmp_path / "run.jsonl"
    f.write_text("".join(json.dumps(r) + "\n" for r in recs))
    t = summarize([str(f)])["tuning"]["halo/staging"]
    assert t["winner"] == "device" and t["measured"] == 2
    assert t["errors"] == 1


def test_fleet_at_one_process():
    assert tfleet.process_count() == 1 and tfleet.process_index() == 0
    obj = {"value": [1, 2]}
    assert tfleet.bcast(obj, "t") is obj
    from tpu_mpi_tests.tune import fleet as jfleet

    assert tfleet.MAX_PAYLOAD == jfleet.MAX_PAYLOAD
    assert tfleet._encode({"a": 1}) == '{"a": 1}'
    with pytest.raises(ValueError, match="exceeds"):
        tfleet._encode("x" * tfleet.MAX_PAYLOAD)


# ---------------------------------------------------------------- packs


def _entry(value, t, fp="device=cpu;ndev=1;platform=cpu;procs=1"):
    return {"value": value, "seconds": 0.1, "knob": "k", "fingerprint": fp,
            "t": t}


def test_pack_documents_and_conflicts_equal(tmp_path):
    a = {"k|f1": _entry(1, 10.0), "k|f2": _entry("x", 5.0),
         "k|f4": _entry(3, 1.0, fp="device=d;hosts=2;rph=4;ndev=8")}
    b = {"k|f1": _entry(2, 20.0), "k|f2": _entry("x", 7.0),
         "k|f3": _entry({"t": 1}, None)}
    assert tpack.merge_entries(a, b) == jpack.merge_entries(a, b)
    merged, conflicts = tpack.merge_entries(a, b)
    assert merged["k|f1"]["value"] == 2 and len(conflicts) == 1
    for e in (a, b, merged, {}):
        tdoc, jdoc = tpack.make_pack(e), jpack.make_pack(e)
        assert {k: v for k, v in tdoc.items() if k != "engine"} == \
            {k: v for k, v in jdoc.items() if k != "engine"}
    assert tpack.entry_topologies(a) == jpack.entry_topologies(a) == {
        "flat", "h2x4"}
    tc = tcache.ScheduleCache(str(tmp_path / "t.json"))
    jc = JaxCache(str(tmp_path / "j.json"))
    tc.entries, jc.entries = dict(a), dict(a)
    assert tpack.absorb(tc, tpack.make_pack(b)) == \
        jpack.absorb(jc, jpack.make_pack(b))
    assert tc.entries == jc.entries
    bad = tmp_path / "bad.json"
    bad.write_text("{nope")
    assert tpack.load_pack(str(bad))["entries"] == {}


def _cli(*argv):
    return subprocess.run(
        [sys.executable, "-m", "tpu_mpi_tests_torch.tune.pack", *argv],
        cwd=REPO, capture_output=True, text=True, timeout=120)


def test_pack_cli_round_trip(tmp_path):
    cache = tmp_path / "tune.json"
    c = tcache.ScheduleCache.load(str(cache))
    c.store("stencil/tier", tfp.fingerprint(dtype="float32", n=64,
                                            world=1), "xla", seconds=1e-4)
    c.save()
    pack = tmp_path / "p.json"
    r = _cli("pack", "--cache", str(cache), "-o", str(pack))
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith(f"PACK {pack}: 1 entries, 1 knobs, "
                               f"devices=cpu worlds=1 procs=1 topo=flat")
    doc = json.loads(pack.read_text())
    assert jpack.load_pack(str(pack))["entries"] == doc["entries"]
    fresh = tmp_path / "fresh.json"
    r = _cli("import", str(pack), "--cache", str(fresh), "--dry-run")
    assert r.returncode == 0 and "would write" in r.stdout
    assert not fresh.exists()
    r = _cli("import", str(pack), "--cache", str(fresh))
    assert r.returncode == 0 and "1 added" in r.stdout
    assert tcache.ScheduleCache.load(str(fresh)).entries == \
        tcache.ScheduleCache.load(str(cache)).entries
    merged = tmp_path / "m.json"
    r = _cli("merge", str(pack), str(pack), "-o", str(merged))
    assert r.returncode == 0 and "0 conflict(s)" in r.stdout
    assert _cli("pack", "--cache", str(tmp_path / "none.json"), "-o",
                str(pack)).returncode == 2

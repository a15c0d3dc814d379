"""Link classes of the port (``comm/topology.py``) held against the JAX
package's ``comm/topology.py``.

* The map: ``TopologyMap`` (``link_class`` of every pair, ``classes``,
  ``label``, ``ranks_per_host``, ``is_flat``) and ``topo_record`` against
  JAX ``discover`` on fabricated devices of the same host layout; the
  degrade to a declared-flat map.
* The one-host repair: the port's ``kind: "topo"`` record of a world on
  one host is the JAX record of the same layout (a discovered map with
  ``hosts``, ``ranks_per_host``, ``host_by_rank`` and, at world >= 2,
  ``link_classes``), where it used to be the declared-flat record.
* The stamps: ``mesh_link_meta`` and ``mesh_partner_links`` on the world
  ring, a process grid's axes and the two-level mesh's against the JAX
  helpers on fabricated meshes; then, on a gloo world of 4 launched as
  two hosts of 2 (``tests/torch_dist_workers.py``, suite ``topo``), every
  stamped wrapper's spans name ``inter_host`` where the JAX stamps do,
  the meshes' inner axes ``intra_host``, and on the world's own one-host
  layout no span carries a stamp. The stamped spans feed the live
  registry's per-link series and the trace's per-link byte counter, both
  byte for byte the JAX package's.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_dist_workers as W
from tpu_mpi_tests.comm import topology as JT
from tpu_mpi_tests.instrument import timeline as JTL
from tpu_mpi_tests.instrument.export import render_openmetrics as jrender
from tpu_mpi_tests.instrument.metrics import MetricsRegistry as JReg
from tpu_mpi_tests_torch.comm import dist
from tpu_mpi_tests_torch.comm import mesh as MS
from tpu_mpi_tests_torch.comm import topology as TP
from tpu_mpi_tests_torch.instrument import manifest
from tpu_mpi_tests_torch.instrument import timeline as TL
from tpu_mpi_tests_torch.instrument.export import render_openmetrics
from tpu_mpi_tests_torch.instrument.metrics import MetricsRegistry


class _Dev:
    """A fabricated JAX device: the attribute discovery reads."""

    def __init__(self, process_index=None):
        if process_index is not None:
            self.process_index = process_index


class _Mesh:
    """A JAX mesh stand-in for the stamp helpers (``devices`` and
    ``axis_names``, hashable by identity like the real Mesh)."""

    def __init__(self, shape, axis_names, devs):
        self.axis_names = axis_names
        self.devices = np.empty(shape, dtype=object)
        self.devices.ravel()[:] = devs


def _devs(hosts):
    return [_Dev(h) for h in hosts]


#: host index a rank; None is a rank that reports no host
LAYOUTS = [(0,), (0, 0), (0, 1), (0, 0, 1, 1), (0, 1, 2, 3), (0, 0, 0, 0),
           (0, 0, 1), (1, 1, 0, 0), (0, 1, 0, 1), (0, 0, 0, 1, 1, 1),
           (0, 0, 1, 1, 2, 2, 3, 3), (0, None), (True, True)]


@pytest.mark.parametrize("hosts", LAYOUTS, ids=str)
def test_map_matches_jax_discover(hosts):
    t = TP.discover(hosts)
    j = JT.discover([_Dev(h) if h is not None else _Dev() for h in hosts])
    assert (t.world, t.hosts, t.slices, t.declared) == \
        (j.world, j.hosts, j.slices, j.declared)
    assert (t.num_hosts, t.ranks_per_host, t.is_flat, t.label(),
            t.classes()) == (j.num_hosts, j.ranks_per_host, j.is_flat,
                             j.label(), j.classes())
    n = len(hosts)
    assert [t.link_class(a, b) for a in range(n) for b in range(n)] == \
        [j.link_class(a, b) for a in range(n) for b in range(n)]
    assert TP.topo_record(t) == JT.topo_record(j)


def test_vocabulary_and_strength_are_the_jax_ones():
    assert TP.LINK_CLASSES == JT.LINK_CLASSES
    for a in TP.LINK_CLASSES:
        for b in TP.LINK_CLASSES:
            assert TP.stronger(a, b) == JT.stronger(a, b)


def _world(monkeypatch, size, hosts, per):
    monkeypatch.setattr(dist, "world", lambda: dist.World(
        rank=0, size=size, local_rank=0, device=torch.device("cpu"),
        backend=None, hosts=hosts, ranks_per_host=per))


@pytest.mark.parametrize("size", [1, 2, 4, 8])
def test_one_host_topo_record_is_the_jax_record(monkeypatch, size):
    """The repair: a world on one host writes the JAX record of one
    host's devices (discovered, with the host fields; link classes at
    world >= 2), not the declared-flat record it wrote before."""
    _world(monkeypatch, size, 1, size)
    want = JT.topo_record(JT.discover(_devs((0,) * size)))
    assert manifest.topo_record() == want
    assert want["declared"] == "discovered"
    assert want["host_by_rank"] == [0] * size
    assert want.get("link_classes") == (["intra_host"] if size > 1
                                        else None)
    # the manifest stays one host's: no topology fields, as in JAX
    m = manifest.run_manifest("cpu", argv=["x"])
    assert not {"hosts", "topology"} & set(m)


def test_live_one_host_record_matches_jax_current():
    """At the test process's world (one rank, one host) against the JAX
    map of this process's first device."""
    import jax

    assert manifest.topo_record() == JT.topo_record(
        JT.discover(jax.devices()[:1]))


@pytest.mark.parametrize("size,hosts,per,want", [
    (4, 2, 2, (0, 0, 1, 1)), (8, 2, 4, (0,) * 4 + (1,) * 4),
    (4, 4, 1, (0, 1, 2, 3)), (4, 2, 3, None), (3, 2, 2, None)])
def test_world_layout_is_host_major_or_declared_flat(monkeypatch, size,
                                                     hosts, per, want):
    """Ranks numbered host-major from the world's layout; a layout whose
    hosts carry unequal rank counts is declared flat (fields absent)."""
    _world(monkeypatch, size, hosts, per)
    t = TP.current()
    assert t.hosts == want
    j = JT.discover(_devs(want) if want else [_Dev()] * size)
    assert TP.topo_record() == JT.topo_record(j)
    m = manifest.run_manifest("cpu", argv=["x"])
    if want and hosts > 1:
        assert (m["hosts"], m["ranks_per_host"], m["topology"]) == \
            (hosts, per, f"h{hosts}x{per}")
    else:
        assert "hosts" not in m


#: (hosts, ranks a host) of the fabricated worlds the stamps run on
STAMP_WORLDS = [(1, 4), (2, 2), (4, 1), (2, 4), (4, 2), (2, 3)]


def _grids(n):
    return [(px, n // px) for px in range(1, n + 1) if n % px == 0]


@pytest.mark.parametrize("hosts,per", STAMP_WORLDS, ids=str)
def test_stamps_match_the_jax_helpers(monkeypatch, hosts, per):
    n = hosts * per
    _world(monkeypatch, n, hosts, per)
    devs = _devs([r // per for r in range(n)])
    jworld = _Mesh((n,), ("shard",), devs)
    assert TP.mesh_link_meta() == JT.mesh_link_meta(jworld, "shard")
    for partners, per_ in (((-1, 1), False), ((-1, 1), True),
                           ((1,), True)):
        assert TP.mesh_partner_links(None, "shard", partners, per_) == \
            JT.mesh_partner_links(jworld, "shard", partners, per_)
    for px, py in _grids(n):
        grid = MS.make_grid(px, py)
        jgrid = _Mesh((px, py), ("x", "y"), devs)
        for ax in ("x", "y"):
            assert TP.mesh_link_meta(grid, ax) == \
                JT.mesh_link_meta(jgrid, ax)
            assert TP.mesh_partner_links(grid, ax, (-1, 1), False) == \
                JT.mesh_partner_links(jgrid, ax, (-1, 1), False)
    two = MS.Mesh2Level(dcn=MS.Ring(rank=0, size=hosts),
                        ici=MS.Ring(rank=0, size=per))
    jtwo = _Mesh((hosts, per), ("dcn", "ici"), devs)
    for ax in ("dcn", "ici"):
        assert TP.mesh_link_meta(two, ax) == JT.mesh_link_meta(jtwo, ax)


def test_stamps_refuse_an_unknown_axis(monkeypatch):
    _world(monkeypatch, 4, 2, 2)
    with pytest.raises(ValueError, match="axes x, y"):
        TP.mesh_link_meta(MS.make_grid(2, 2), "z")


# ------------------------------------------------- a gloo world of four


@pytest.fixture(scope="module")
def topo_world(tmp_path_factory):
    d = W.spawn("topo", 4, tmp_path_factory.mktemp("topo4"))
    return d, [json.loads(Path(d, f"topo.r{r}.txt").read_text())
               for r in range(4)]


HOSTS = {"one_host": (0, 0, 0, 0), "two_hosts": (0, 0, 1, 1)}


@pytest.mark.parametrize("layout", list(HOSTS))
def test_gloo_world_topo_record_and_mesh_stamps(topo_world, layout):
    _, res = topo_world
    devs = _devs(HOSTS[layout])
    for r, got in enumerate(res):
        g = got[layout]
        assert g["topo"] == JT.topo_record(JT.discover(devs))
        assert g["world"] == JT.mesh_link_meta(
            _Mesh((4,), ("shard",), devs), "shard")
        grid = _Mesh((2, 2), ("x", "y"), devs)
        assert g["grid_x"] == JT.mesh_link_meta(grid, "x")
        assert g["grid_y"] == JT.mesh_link_meta(grid, "y")
        assert g["grid_x_partners"] == JT.mesh_partner_links(
            grid, "x", (-1, 1), False)
        two = _Mesh((2, 2), ("dcn", "ici"), devs)
        assert g["dcn"] == JT.mesh_link_meta(two, "dcn")
        assert g["ici"] == JT.mesh_link_meta(two, "ici")
    two_hosts = res[0]["two_hosts"]
    assert (two_hosts["dcn"], two_hosts["ici"]) == (
        {"link": "inter_host"}, {"link": "intra_host"})
    assert res[0]["two_hosts"]["manifest"] == {
        "hosts": 2, "ranks_per_host": 2, "topology": "h2x2"}
    assert res[0]["one_host"]["manifest"] == {}


#: the ops the suite stamps, in call order (the CPU plain versions of the
#: hand tiers gather through ``all_gather``, which records its own span)
STAMPED_OPS = ["halo_exchange", "halo_exchange", "allreduce",
               "reduce_scatter", "all_gather", "all_gather_inplace",
               "all_gather", "all_gather_rdma", "all_gather",
               "all_gather_oneshot", "all_gather", "allreduce_rdma",
               "all_gather", "allreduce_oneshot", "ring_attention",
               "ulysses_attention", "moe", "embedding_lookup",
               "embedding_scatter_add"]


def _spans(res, layout, rank):
    return [r for r in res[rank][layout]["records"] if r["kind"] == "span"]


@pytest.mark.parametrize("rank", range(4))
def test_gloo_world_spans_carry_the_jax_stamps(topo_world, rank):
    _, res = topo_world
    devs = _devs(HOSTS["two_hosts"])
    jworld = _Mesh((4,), ("shard",), devs)
    spans = _spans(res, "two_hosts", rank)
    assert [s["op"] for s in spans] == STAMPED_OPS
    link = JT.mesh_link_meta(jworld, "shard")
    assert link == {"link": "inter_host"}
    halo = [s for s in spans if s["op"] == "halo_exchange"]
    for s, periodic in zip(halo, (False, True)):
        assert s["periodic"] is periodic
        want = JT.mesh_partner_links(jworld, "shard", (-1, 1), periodic)
        assert {k: s[k] for k in want} == want
    (ring,) = [s for s in spans if s["op"] == "ring_attention"]
    want = JT.mesh_partner_links(jworld, "shard", (1,), True)
    assert {k: ring[k] for k in want} == want
    for s in spans:
        if s["op"] not in ("halo_exchange", "ring_attention"):
            assert s["link"] == link["link"] and "partner_link" not in s
    # the route record is not a span and carries no stamp (the JAX one)
    (route,) = [r for r in res[rank]["two_hosts"]["records"]
                if r["kind"] == "route"]
    assert "link" not in route
    # one host: the same spans, no stamp on any of them
    flat = _spans(res, "one_host", rank)
    assert [s["op"] for s in flat] == STAMPED_OPS
    assert not any({"link", "partner_link"} & set(s) for s in flat)


def _feed(cls, records):
    reg = cls(wall=lambda: 1000.0, clock=lambda: 50.0)
    for rec in records:
        reg.observe(rec)
    return reg


@pytest.mark.parametrize("layout", list(HOSTS))
def test_link_series_and_trace_counter_are_the_jax_ones(topo_world,
                                                        layout, tmp_path):
    """The stamped spans through the live registry (its per-link series)
    and the trace merge (its per-link byte counter), port against JAX,
    byte for byte; neither appears on one host."""
    _, res = topo_world
    recs = [r for rank in range(4) for r in res[rank][layout]["records"]]
    text = render_openmetrics(_feed(MetricsRegistry, recs))
    assert text == jrender(_feed(JReg, recs))
    assert ('tpumt_span_link_bytes_total{link="inter_host"}' in text) == \
        (layout == "two_hosts")
    files = []
    for rank in range(4):
        f = tmp_path / f"run.p{rank}.jsonl"
        f.write_text("".join(json.dumps(r) + "\n" for r in [
            {"kind": "manifest", "process_index": rank, "process_count": 4},
            {"kind": "clock_sync", "rank": rank, "offset_s": 0.0,
             "spread_s": 0.0, "run_sync_us": 7},
            *res[rank][layout]["records"]]))
        files.append(str(f))
    port = TL.chrome_trace(files, run_sync_us=7)
    jax = JTL.chrome_trace(files, run_sync_us=7)

    def counters(doc, name):
        return [(e["pid"], e["ts"], e["args"]) for e in doc["traceEvents"]
                if e.get("ph") == "C" and e["name"] == name]

    for name in ("comm bytes by link", "comm bytes sent"):
        assert counters(port, name) == counters(jax, name)
    assert bool(counters(port, "comm bytes by link")) == \
        (layout == "two_hosts")

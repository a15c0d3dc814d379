"""Host/link-class topology and span link attribution (≅
``tpu_mpi_tests/comm/topology.py``).

The reference probes machine structure as a first-class signal — node
count via ``MPI_Comm_split_type(MPI_COMM_TYPE_SHARED)``
(``mpi_daxpy_nvtx.cc:72-82``) — because the link a message rides dominates
its cost at scale. This module groups the ranks into hosts and classifies
every directed rank pair into a link class::

    self < intra_host < inter_host < inter_slice

ordered by strength: the strongest class a collective group crosses is
the link that prices it. ``inter_slice`` stays in the vocabulary so the
records keep the JAX package's, but nothing here reports a slice: the
card has no slice axis.

Where the JAX function reads ``process_index`` from a device list, this
one reads the port's own rank layout, :func:`comm.dist.world`: the hosts
the launcher's ranks found by their host-name gather, ranks numbered
host-major (rank r on host ``r // ranks_per_host``, as
``comm/mesh.make_mesh_2level`` numbers them). :func:`discover` also takes
an explicit host index a rank (tests fabricate layouts that way).

Degrade contract (the JAX one): a rank that reports no host — or a world
whose hosts carry unequal rank counts, which the world does not describe
rank by rank — yields a *declared* ``flat`` map, host fields absent, never
guessed. One host is a *discovered* map (``hosts == (0,) * world``),
whose stamps are empty all the same: :func:`mesh_link_meta` and
:func:`mesh_partner_links` return ``{}`` on any flat map, so a one-host
run's spans stay exactly what they were.

The stamps are resolved once per ring or group and cached (by the rings'
members and the host layout). A wrapper built once resolves its stamp
when it is built; a collective called per op asks for it only while
spans record (``telemetry.armed()``), so a run with telemetry off pays
one attribute check a call.

No NVLink probe: the JAX record has no field for one, so the port adds
none (ROADMAP queue 1).
"""

from __future__ import annotations

import collections
import dataclasses
import functools


#: link classes, weakest to strongest — index order IS the strength
#: ordering (the strongest pair class prices a collective group)
LINK_CLASSES = ("self", "intra_host", "inter_host", "inter_slice")

_STRENGTH = {c: i for i, c in enumerate(LINK_CLASSES)}


def stronger(a: str, b: str) -> str:
    """The stronger (more expensive) of two link classes."""
    return a if _STRENGTH[a] >= _STRENGTH[b] else b


@dataclasses.dataclass(frozen=True)
class TopologyMap:
    """Rank → host/slice structure of one rank ordering (≅ the JAX
    class, field for field).

    ``hosts``/``slices`` are per-rank group indices in rank order.
    ``None`` means the axis was not reported — a declared-flat degrade,
    not a measured single group."""

    world: int
    hosts: tuple[int, ...] | None
    slices: tuple[int, ...] | None
    declared: str  # "discovered" | "flat"

    @property
    def num_hosts(self) -> int:
        return len(set(self.hosts)) if self.hosts else 1

    @property
    def num_slices(self) -> int:
        return len(set(self.slices)) if self.slices else 1

    @property
    def ranks_per_host(self) -> int | None:
        """Uniform ranks-per-host, or ``None`` when ragged (absent,
        never averaged)."""
        if not self.hosts:
            return None
        counts = set(collections.Counter(self.hosts).values())
        return counts.pop() if len(counts) == 1 else None

    @property
    def is_flat(self) -> bool:
        """One host, one slice (measured or declared): nothing to
        attribute — every stamp helper goes silent."""
        return self.num_hosts <= 1 and self.num_slices <= 1

    def link_class(self, a: int, b: int) -> str:
        """Directed-pair link class for ranks ``a``→``b``. With no
        host/slice info every cross-rank pair reads ``intra_host``
        (callers gate on :attr:`is_flat` before stamping)."""
        if a == b:
            return "self"
        if self.slices is not None and self.slices[a] != self.slices[b]:
            return "inter_slice"
        if self.hosts is not None and self.hosts[a] != self.hosts[b]:
            return "inter_host"
        return "intra_host"

    def classes(self) -> tuple[str, ...]:
        """Cross-rank link classes present, weakest first, from the group
        structure (no O(world²) pair sweep)."""
        if self.world <= 1:
            return ()
        hosts = self.hosts or (0,) * self.world
        slices = self.slices or (0,) * self.world
        groups = collections.Counter(zip(slices, hosts))
        hosts_by_slice: dict[int, set[int]] = {}
        for s, h in groups:
            hosts_by_slice.setdefault(s, set()).add(h)
        present = set()
        if any(n >= 2 for n in groups.values()):
            present.add("intra_host")
        if any(len(hs) >= 2 for hs in hosts_by_slice.values()):
            present.add("inter_host")
        if len(hosts_by_slice) >= 2:
            present.add("inter_slice")
        return tuple(c for c in LINK_CLASSES if c in present)

    def label(self) -> str:
        """Shape label: ``h{hosts}x{ranks_per_host}`` (``h2x4``),
        ``h{hosts}`` when ragged, ``s{slices}`` prefix with a multi-slice
        axis, ``flat`` otherwise."""
        if self.is_flat:
            return "flat"
        rph = self.ranks_per_host
        lbl = f"h{self.num_hosts}" + (f"x{rph}" if rph else "")
        if self.num_slices > 1:
            lbl = f"s{self.num_slices}" + lbl
        return lbl


def _host_major(size: int, hosts: int, per: int) -> "tuple[int, ...] | None":
    """Rank r on host ``r // per``; None when the hosts carry unequal
    rank counts (the world keeps only this rank's count, so another
    rank's host is unknown)."""
    if per < 1 or hosts * per != size:
        return None
    return tuple(r // per for r in range(size))


def discover(hosts=None) -> TopologyMap:
    """A :class:`TopologyMap` from one host index a rank, in rank order
    (default: the joined world's layout, :func:`current`). Any entry that
    is not an integer host index (None: the rank reports no host)
    declares the whole map flat — fields absent, never guessed. No slice
    axis."""
    if hosts is None:
        return current()
    hosts = list(hosts)
    for h in hosts:
        if not isinstance(h, int) or isinstance(h, bool):
            return TopologyMap(world=len(hosts), hosts=None, slices=None,
                               declared="flat")
    return TopologyMap(world=len(hosts), hosts=tuple(hosts), slices=None,
                       declared="discovered")


def current() -> TopologyMap:
    """The joined world's map, cached per layout (a test or a driver
    that rejoins another world sees that world's)."""
    from tpu_mpi_tests_torch.comm import dist

    w = dist.world()
    return _current(w.size, w.hosts, w.ranks_per_host)


@functools.lru_cache(maxsize=None)
def _current(size: int, hosts: int, per: int) -> TopologyMap:
    layout = _host_major(size, hosts, per)
    if layout is None:
        return TopologyMap(world=size, hosts=None, slices=None,
                           declared="flat")
    return discover(layout)


def topo_record(topo: TopologyMap | None = None) -> dict:
    """The ``kind: "topo"`` JSONL record written after the manifest
    (the JAX function's fields): world, shape label, host grouping and
    the link classes present. Host/slice fields are ABSENT (not null) on
    a declared-flat map."""
    topo = current() if topo is None else topo
    rec = {
        "kind": "topo",
        "world": topo.world,
        "topology": topo.label(),
        "declared": topo.declared,
        "hosts": topo.num_hosts if topo.hosts is not None else None,
        "ranks_per_host": (topo.ranks_per_host
                           if topo.hosts is not None else None),
        "host_by_rank": (list(topo.hosts)
                         if topo.hosts is not None else None),
        "slices": topo.num_slices if topo.slices is not None else None,
        # a declared-flat map measured nothing: claiming intra_host for
        # its pairs would be the guess the degrade contract forbids
        "link_classes": (list(topo.classes()) or None
                         if topo.declared == "discovered" else None),
    }
    return {k: v for k, v in rec.items() if v is not None}


def axis_rings(mesh=None, axis_name: str = "shard") -> tuple:
    """The rank rings one mesh axis's collectives run over, each a tuple
    of global ranks in ring order (≅ JAX ``_axis_rings``): the world ring
    for ``mesh=None`` (the port's collectives, halo exchange and
    attention run over the world, axis ``shard``); the ``x`` or ``y``
    rings of a ``comm.mesh.Grid`` (rank r at ``divmod(r, py)``); the
    ``dcn`` or ``ici`` rings of a ``comm.mesh.Mesh2Level``; a lone
    ``comm.mesh.Ring``'s own members."""
    from tpu_mpi_tests_torch.comm import dist

    if mesh is None:
        return (tuple(range(dist.world().size)),)
    if hasattr(mesh, "px"):  # Grid
        px, py = mesh.px, mesh.py
        if axis_name == "x":
            return tuple(tuple(x * py + y for x in range(px))
                         for y in range(py))
        if axis_name == "y":
            return tuple(tuple(x * py + y for y in range(py))
                         for x in range(px))
        raise ValueError(f"a process grid has axes x, y, not {axis_name!r}")
    if hasattr(mesh, "dcn"):  # Mesh2Level
        hosts, per = mesh.dcn.size, mesh.ici.size
        if axis_name == "dcn":
            return tuple(tuple(h * per + i for h in range(hosts))
                         for i in range(per))
        if axis_name == "ici":
            return tuple(tuple(h * per + i for i in range(per))
                         for h in range(hosts))
        raise ValueError(f"the two-level mesh has axes dcn, ici, not "
                         f"{axis_name!r}")
    return (tuple(mesh.peer(p) for p in range(mesh.size)),)


def _ring_topos(rings: tuple, topo: TopologyMap):
    """Per-ring positional maps, or None when the rings' ranks form a
    flat map (the stamp gate)."""
    if topo.hosts is None:
        return None
    members = [r for ring in rings for r in ring]
    if discover([topo.hosts[r] for r in members]).is_flat:
        return None
    return [discover([topo.hosts[r] for r in ring]) for ring in rings]


def mesh_link_meta(mesh=None, axis_name: str = "shard") -> dict:
    """``{"link": cls}`` for collective spans over ``axis_name`` — the
    strongest link class any collective group on that axis crosses — or
    ``{}`` on a flat map (flat runs stamp nothing). Cached per rings and
    host layout."""
    return _link_meta(axis_rings(mesh, axis_name), current())


@functools.lru_cache(maxsize=None)
def _link_meta(rings: tuple, topo: TopologyMap) -> dict:
    topos = _ring_topos(rings, topo)
    if topos is None:
        return {}
    cls = None
    for t in topos:
        present = t.classes()
        if present:
            c = present[-1]
            cls = c if cls is None else stronger(cls, c)
    return {"link": cls} if cls else {}


def mesh_partner_links(mesh=None, axis_name: str = "shard",
                       partners: tuple = (-1, 1),
                       periodic: bool = False) -> dict:
    """Per-offset link classes for neighbour-exchange spans:
    ``{"partner_link": [cls per offset], "link": strongest}`` parallel to
    the ``partners`` ring offsets, or ``{}`` on a flat map. Each offset's
    class is the strongest pair class any rank's edge at that offset
    crosses. Cached per rings, offsets and host layout."""
    return _partner_links(axis_rings(mesh, axis_name),
                          tuple(int(d) for d in partners), bool(periodic),
                          current())


@functools.lru_cache(maxsize=None)
def _partner_links(rings: tuple, partners: tuple, periodic: bool,
                   topo: TopologyMap) -> dict:
    topos = _ring_topos(rings, topo)
    if topos is None:
        return {}
    links = []
    for d in partners:
        cls = None
        for t in topos:
            n = t.world
            for i in range(n):
                j = i + d
                if periodic:
                    j %= n
                elif not (0 <= j < n):
                    continue
                c = t.link_class(i, j)
                cls = c if cls is None else stronger(cls, c)
        links.append(cls or "self")
    strongest = links[0]
    for c in links[1:]:
        strongest = stronger(strongest, c)
    return {"partner_link": links, "link": strongest}

"""Portable schedule packs (≅ ``tpu_mpi_tests/tune/pack.py``): tune
once, ship the schedule with the deployment.

A pack is a fingerprint-keyed artifact exported from a tune cache: the
measured winners plus provenance (device names, rank and process counts,
topologies, engine version), so a pack says what hardware its schedules
are valid on. A fleet of identical machines tunes on one, packs the
cache, and every deployment preloads the artifact (``--tune-pack`` on
any driver); the fingerprints then let a schedule apply only where it
was measured.

Subcommands (``python -m tpu_mpi_tests_torch.tune.pack``):

* ``pack [--cache PATH] -o PACK`` — export a cache as a pack;
* ``merge A B -o OUT`` — union two packs; a (knob, fingerprint) key
  measured in both resolves newer-measurement-wins (the entry's ``t``
  stamp), and every such conflict is reported;
* ``import PACK [--cache PATH] [--dry-run]`` — merge a pack into a cache
  file by the same rule; ``--dry-run`` prints the add/update/keep diff
  without writing; a pack whose topologies share nothing with the
  cache's is refused (``--allow-topology-mismatch`` overrides).

A corrupt, unreadable or foreign pack degrades to an empty one
(reported, never a crash), as the cache file does. The artifact's shape
is the JAX package's::

    {"version": 1, "kind": "tpumt-tune-pack",
     "engine": "<tpu-mpi-tests version>",
     "provenance": {"devices": [...], "platforms": [...],
                    "worlds": [...], "procs": [...],
                    "knobs": [...], "topologies": [...], "entries": N},
     "entries": {"<knob>|<fingerprint>": {value, seconds, knob,
                                          fingerprint, t}}}
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from tpu_mpi_tests_torch.tune.cache import ScheduleCache, default_cache_path

PACK_VERSION = 1
PACK_KIND = "tpumt-tune-pack"


def _engine_version() -> str:
    try:
        from importlib.metadata import version

        return version("tpu-mpi-tests")
    except Exception:
        return "uninstalled"


def _fp_fields(fp: str) -> dict[str, str]:
    """``k=v;k=v`` fingerprint → dict (malformed parts skipped)."""
    out: dict[str, str] = {}
    for part in (fp or "").split(";"):
        k, sep, v = part.partition("=")
        if sep:
            out[k] = v
    return out


def _fp_topology(fields: dict[str, str]) -> str:
    """Topology label of one fingerprint: ``h{hosts}x{rph}`` from the
    topology fields (``tune/fingerprint`` stamps them only on more than
    one host), ``flat`` when absent (a one-host measurement)."""
    hosts = fields.get("hosts")
    if not hosts:
        return "flat"
    rph = fields.get("rph")
    return f"h{hosts}" + (f"x{rph}" if rph else "")


def entry_topologies(entries: dict) -> set[str]:
    """The set of topology shape labels a pack/cache's entries were
    measured on (see :func:`_fp_topology`)."""
    topos: set[str] = set()
    for key, e in entries.items():
        if not isinstance(e, dict):
            continue
        topos.add(_fp_topology(_fp_fields(
            e.get("fingerprint") or key.split("|", 1)[-1]
        )))
    return topos


def provenance(entries: dict) -> dict:
    """What hardware/topology these winners were measured on, read back
    out of the fingerprints the sweeps stored them under."""
    devices: set[str] = set()
    platforms: set[str] = set()
    worlds: set[str] = set()
    procs: set[str] = set()
    knobs: set[str] = set()
    for key, e in entries.items():
        if not isinstance(e, dict):
            continue
        knobs.add(e.get("knob") or key.split("|", 1)[0])
        f = _fp_fields(e.get("fingerprint")
                       or key.split("|", 1)[-1])
        for field, dst in (("device", devices), ("platform", platforms),
                           ("ndev", worlds), ("procs", procs)):
            if field in f:
                dst.add(f[field])
    return {
        "devices": sorted(devices),
        "platforms": sorted(platforms),
        "worlds": sorted(worlds),
        "procs": sorted(procs),
        "knobs": sorted(knobs),
        "topologies": sorted(entry_topologies(entries)),
        "entries": len(entries),
    }


def make_pack(entries: dict) -> dict:
    return {
        "version": PACK_VERSION,
        "kind": PACK_KIND,
        "engine": _engine_version(),
        "provenance": provenance(entries),
        "entries": dict(entries),
    }


def load_pack(path: str) -> dict:
    """A pack document from ``path``; corrupted/foreign content degrades
    to an empty pack (``entries == {}``) so a stale artifact can never
    crash a deployment that ships it."""
    try:
        doc = json.loads(Path(path).read_text())
    except (OSError, json.JSONDecodeError, UnicodeDecodeError):
        return make_pack({})
    if (
        not isinstance(doc, dict)
        or doc.get("version") != PACK_VERSION
        or doc.get("kind") != PACK_KIND
        or not isinstance(doc.get("entries"), dict)
    ):
        return make_pack({})
    doc["entries"] = {
        k: v for k, v in doc["entries"].items() if isinstance(v, dict)
    }
    return doc


def _stamp(entry: dict) -> float:
    t = entry.get("t")
    return float(t) if isinstance(t, (int, float)) else 0.0


def merge_entries(
    a: dict, b: dict
) -> tuple[dict, list[tuple[str, dict, dict]]]:
    """Union of two entry maps. A key present in both with a different
    value is a CONFLICT: the newer measurement (the ``t`` stamp; a
    pre-timestamp entry reads as oldest) wins, and the conflict is
    returned as ``(key, kept, dropped)`` so callers report it — two
    fleets that measured different winners for one fingerprint is a
    fact worth surfacing."""
    merged = dict(a)
    conflicts: list[tuple[str, dict, dict]] = []
    for key, eb in b.items():
        ea = merged.get(key)
        if ea is None:
            merged[key] = eb
            continue
        if ea.get("value") == eb.get("value"):
            # same winner: keep the newer measurement metadata
            if _stamp(eb) > _stamp(ea):
                merged[key] = eb
            continue
        kept, dropped = (ea, eb) if _stamp(ea) >= _stamp(eb) else (eb, ea)
        merged[key] = kept
        conflicts.append((key, kept, dropped))
    return merged, conflicts


def absorb(cache: ScheduleCache, pack_doc: dict) -> int:
    """Preload a pack into a live in-memory cache (the ``--tune-pack``
    path): pack entries fill the gaps, conflicts resolve
    newer-measurement-wins. Returns how many entries were adopted. No
    disk write happens here: rank 0 persists only when a sweep runs."""
    merged, _ = merge_entries(cache.entries, pack_doc.get("entries", {}))
    adopted = sum(
        1 for k, v in merged.items() if cache.entries.get(k) != v
    )
    cache.entries = merged
    return adopted


def _print_conflicts(conflicts) -> None:
    for key, kept, dropped in conflicts:
        print(
            f"CONFLICT {key}: kept={json.dumps(kept.get('value'))} "
            f"(t={_stamp(kept):.0f}) "
            f"dropped={json.dumps(dropped.get('value'))} "
            f"(t={_stamp(dropped):.0f}) — newer measurement wins"
        )


def _cmd_pack(args) -> int:
    cache_path = args.cache or default_cache_path()
    if not Path(cache_path).exists():
        print(f"tpumt-tune: no cache at {cache_path}", file=sys.stderr)
        return 2
    entries = ScheduleCache.load(cache_path).entries
    doc = make_pack(entries)
    Path(args.output).write_text(json.dumps(doc, indent=1,
                                            sort_keys=True) + "\n")
    p = doc["provenance"]
    print(f"PACK {args.output}: {p['entries']} entries, "
          f"{len(p['knobs'])} knobs, devices={','.join(p['devices']) or '-'} "
          f"worlds={','.join(p['worlds']) or '-'} "
          f"procs={','.join(p['procs']) or '-'} "
          f"topo={','.join(p.get('topologies') or []) or '-'} "
          f"engine={doc['engine']}")
    return 0


def _cmd_merge(args) -> int:
    packs = []
    for path in (args.a, args.b):
        if not Path(path).exists():
            print(f"tpumt-tune: no pack at {path}", file=sys.stderr)
            return 2
        doc = load_pack(path)
        if not doc["entries"]:
            print(f"NOTE {path}: empty or unreadable pack "
                  f"(corrupted packs degrade to empty)")
        packs.append(doc)
    merged, conflicts = merge_entries(packs[0]["entries"],
                                      packs[1]["entries"])
    _print_conflicts(conflicts)
    doc = make_pack(merged)
    Path(args.output).write_text(json.dumps(doc, indent=1,
                                            sort_keys=True) + "\n")
    print(f"MERGE {args.output}: {len(merged)} entries "
          f"({len(conflicts)} conflict(s) resolved newer-wins)")
    return 0


def _cmd_import(args) -> int:
    if not Path(args.pack).exists():
        print(f"tpumt-tune: no pack at {args.pack}", file=sys.stderr)
        return 2
    doc = load_pack(args.pack)
    if not doc["entries"]:
        print(f"NOTE {args.pack}: empty or unreadable pack "
              f"(corrupted packs degrade to empty)")
    cache_path = args.cache or default_cache_path()
    cache = ScheduleCache.load(cache_path)
    # topology gate: a pack measured on one machine shape contributes
    # nothing on another (the fingerprints never match), so disjoint
    # non-empty shape sets refuse with a NOTE; an empty destination
    # cache has no shape evidence and accepts
    pack_topos = entry_topologies(doc["entries"])
    cache_topos = entry_topologies(cache.entries)
    if (pack_topos and cache_topos and not (pack_topos & cache_topos)
            and not args.allow_topology_mismatch):
        print(f"NOTE topology mismatch: pack measured on "
              f"{','.join(sorted(pack_topos))}, cache holds "
              f"{','.join(sorted(cache_topos))} entries — no schedule "
              f"could ever resolve; refusing import "
              f"(--allow-topology-mismatch to override)")
        return 3
    merged, conflicts = merge_entries(cache.entries, doc["entries"])
    added = [k for k in merged if k not in cache.entries]
    updated = [k for k in merged
               if k in cache.entries and merged[k] != cache.entries[k]]
    _print_conflicts(conflicts)
    for k in sorted(added):
        print(f"ADD  {k} = {json.dumps(merged[k].get('value'))}")
    for k in sorted(updated):
        print(f"UPD  {k} = {json.dumps(merged[k].get('value'))}")
    verb = "would write" if args.dry_run else "wrote"
    print(f"IMPORT {cache_path}: {len(added)} added, "
          f"{len(updated)} updated, "
          f"{len(merged) - len(added) - len(updated)} kept ({verb})")
    if not args.dry_run:
        cache.entries = merged
        cache.save()
    return 0


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m tpu_mpi_tests_torch.tune.pack",
        description="portable schedule packs: export (pack), union "
        "(merge), and preload (import) fingerprint-keyed tuned-schedule "
        "artifacts so a fleet of identical machines tunes once",
    )
    sub = p.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("pack", help="export a tune cache as a pack")
    sp.add_argument("--cache", default=None, metavar="PATH",
                    help="cache file to export (default: "
                    "$TPU_MPI_TUNE_CACHE, else ~/.cache/tpumt/tune.json)")
    sp.add_argument("-o", "--output", required=True, metavar="PACK",
                    help="pack file to write")
    sp.set_defaults(fn=_cmd_pack)

    sm = sub.add_parser("merge", help="union two packs (newer "
                        "measurement wins; conflicts reported)")
    sm.add_argument("a", help="first pack")
    sm.add_argument("b", help="second pack")
    sm.add_argument("-o", "--output", required=True, metavar="PACK",
                    help="merged pack to write")
    sm.set_defaults(fn=_cmd_merge)

    si = sub.add_parser("import", help="merge a pack into a cache file")
    si.add_argument("pack", help="pack file to import")
    si.add_argument("--cache", default=None, metavar="PATH",
                    help="cache file to import into (default: "
                    "$TPU_MPI_TUNE_CACHE, else ~/.cache/tpumt/tune.json)")
    si.add_argument("--dry-run", action="store_true",
                    help="print the add/update/keep diff without writing")
    si.add_argument("--allow-topology-mismatch", action="store_true",
                    help="import even when the pack's topology shape "
                    "labels share nothing with the destination cache's "
                    "(the entries still only resolve where their "
                    "fingerprints match)")
    si.set_defaults(fn=_cmd_import)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())

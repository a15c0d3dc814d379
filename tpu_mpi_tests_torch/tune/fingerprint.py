"""Schedule-cache keys (≅ ``tpu_mpi_tests/tune/fingerprint.py``): what
has to match for a tuned winner to transfer.

A winner is valid only on the configuration it was measured on, so the
fingerprint pins the axes that move it — the device's name, the
platform, the rank and process counts, the host layout when there is
more than one host, dtype, and a power-of-two shape bucket — into one
canonical ``k=v;k=v`` string.

Two layers, as in the JAX package:

* :func:`device_fields` — this run's identity, read from torch and the
  port's world (``comm/dist.py``, ``comm/mesh.topology``): ``platform``
  is ``gpu`` on the card and ``cpu`` when the run asked for the CPU,
  ``device`` is ``torch.cuda.get_device_name()`` (``;`` replaced by
  ``,``), ``ndev`` the global rank count, ``procs`` the process count,
  ``hosts`` and ``rph`` the host layout when it is not flat (one host),
  ``stack=torch``: the JAX package's fingerprints never carry it, so
  one cache file may hold both packages' entries and neither resolves
  the other's; and on the card ``chain=graph``: the sweeps' chains are
  replays of CUDA graphs (``instrument.timers.chain_rate``), so a
  winner timed by an older port's Python loop of launches, which priced
  the host path and not the kernel, no longer matches;
* :func:`compose` — the pure composition, the JAX function's.

Call sites differ in how much context they have, so lookups may fall
back from the full fingerprint to the device-only one
(:func:`device_fingerprint`); sweeps store their winner under both.
"""

from __future__ import annotations


def shape_bucket(n: int) -> int:
    """Round ``n`` up to the next power of two (1 stays 1): the shape
    axis of the fingerprint."""
    n = int(n)
    if n <= 1:
        return 1
    return 1 << (n - 1).bit_length()


def device_fields() -> tuple[tuple[str, str], ...]:
    """This run's identity fields (see the module docstring). Read on
    every call: a process's world may be joined after import."""
    from tpu_mpi_tests_torch.comm import dist
    from tpu_mpi_tests_torch.comm.mesh import topology

    topo = topology(dist.world().device)
    fields = (
        ("platform", topo.platform),
        ("device", topo.device_kinds[0].replace(";", ",")),
        # ndev, not world: knob contexts pass their ring size as `world`
        ("ndev", str(topo.global_device_count)),
        ("procs", str(topo.process_count)),
        ("stack", "torch"),
    )
    if topo.platform == "gpu":
        fields += (("chain", "graph"),)
    if topo.hosts > 1:
        fields += (("hosts", str(topo.hosts)),
                   ("rph", str(topo.local_device_count)))
    return fields


def topology_label() -> str:
    """This run's topology label in the pack's terms
    (``tune.pack.entry_topologies``): ``flat`` on one host, else
    ``h{hosts}x{ranks per host}``."""
    fields = dict(device_fields())
    if "hosts" not in fields:
        return "flat"
    return f"h{fields['hosts']}x{fields['rph']}"


def compose(base: "dict[str, str] | None" = None, **ctx) -> str:
    """Canonical fingerprint string from explicit fields: sorted ``k=v``
    pairs joined with ``;``; integer ``shape``, ``lq``, ``n``,
    ``extent`` and ``bytes`` fields are bucketed (:func:`shape_bucket`),
    everything else stringified, None fields dropped."""
    fields = dict(base or ())
    for k, v in ctx.items():
        if v is None:
            continue
        if k in ("shape", "lq", "n", "extent", "bytes") and not isinstance(
            v, str
        ):
            v = shape_bucket(v)
        fields[k] = str(v)
    return ";".join(f"{k}={fields[k]}" for k in sorted(fields))


def fingerprint(**ctx) -> str:
    """Full cache key: this run's fields + the caller's context."""
    return compose(dict(device_fields()), **ctx)


def device_fingerprint() -> str:
    """Device-only key: the fallback slot of context-free sites."""
    return compose(dict(device_fields()))

"""OpenMetrics exposition and the live heartbeat for the metrics
registry (≅ ``tpu_mpi_tests/instrument/export.py``; the exposition text
is byte for byte the JAX module's for the same registry state).

Two small pieces, both stdlib-only and both strict consumers of
:class:`~tpu_mpi_tests_torch.instrument.metrics.MetricsRegistry`:

* :class:`MetricsExporter` — an ``http.server`` endpoint on a background
  daemon thread serving the registry as OpenMetrics / Prometheus text at
  ``/metrics`` (armed by ``--metrics-port``; rank 0 by default, every
  rank with ``--metrics-all-ranks``, each at ``port + rank``). Counters
  export with the ``_total`` suffix, rolling histograms as summaries
  (``quantile="0.5"/"0.99"`` + ``_count``/``_sum``), and the body ends
  with ``# EOF``.

* :class:`Heartbeat` — a daemon thread writing periodic ``kind:
  "health" event: "heartbeat"`` records through the reporter's sink:
  sequence number, uptime, record count, queue depth, device memory in
  use and the rolling p50/p99 of the all-ops latency histogram. A rank
  that dies mid-run leaves its last heartbeat in the JSONL; ``stop()``
  writes one final heartbeat, so a clean close reads apart from a kill.

Neither thread touches the card: no CUDA call, no ``.item()``, no
synchronize. They read only the registry, which holds numbers copied
out of records, and the heartbeat's sink only writes a JSONL line.
Neither piece exists on a disarmed run (no ``--metrics-port``: the
module is not imported).
"""

from __future__ import annotations

import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable

from tpu_mpi_tests_torch.instrument.metrics import MetricsRegistry

#: OpenMetrics content type served on /metrics (readable as plain text
#: by curl, parseable by Prometheus' OpenMetrics parser)
CONTENT_TYPE = ("application/openmetrics-text; version=1.0.0; "
                "charset=utf-8")


def _escape_label(v) -> str:
    return (str(v).replace("\\", r"\\").replace('"', r'\"')
            .replace("\n", r"\n"))


def _labels_text(labels: tuple, extra: str = "") -> str:
    parts = [f'{k}="{_escape_label(v)}"' for k, v in labels]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def _num(v) -> str:
    if v is None or v != v:
        return "NaN"
    f = float(v)
    return str(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


def render_openmetrics(registry: MetricsRegistry) -> str:
    """The registry as OpenMetrics text exposition (one string,
    ``# EOF``-terminated). Counter samples carry the ``_total`` suffix,
    histograms export as summaries over their rolling window."""
    lines: list[str] = []
    for name, fam in registry.snapshot().items():
        kind = fam["type"]
        om_type = {"counter": "counter", "gauge": "gauge",
                   "histogram": "summary"}[kind]
        lines.append(f"# TYPE {name} {om_type}")
        for labels, value in fam["samples"]:
            if kind == "counter":
                lines.append(
                    f"{name}_total{_labels_text(labels)} {_num(value)}")
            elif kind == "gauge":
                lines.append(
                    f"{name}{_labels_text(labels)} {_num(value)}")
            else:
                for q, key in (("0.5", "p50"), ("0.99", "p99")):
                    extra = 'quantile="' + q + '"'
                    lines.append(
                        f"{name}{_labels_text(labels, extra)}"
                        f" {_num(value[key])}")
                lines.append(
                    f"{name}_count{_labels_text(labels)} "
                    f"{_num(value['count'])}")
                lines.append(
                    f"{name}_sum{_labels_text(labels)} "
                    f"{_num(value['sum'])}")
    lines.append("# EOF")
    return "\n".join(lines) + "\n"


class MetricsExporter:
    """Background-thread HTTP endpoint serving the registry at
    ``/metrics``. ``port=0`` binds an ephemeral port (tests); the bound
    port is readable as ``.port`` after :meth:`start`."""

    def __init__(self, registry: MetricsRegistry, port: int,
                 host: str = "0.0.0.0"):
        self._registry = registry
        self._host = host
        self.port = int(port)
        self._server: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None

    def start(self) -> "MetricsExporter":
        registry = self._registry

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 — http.server API
                if self.path.split("?")[0] not in ("/metrics", "/"):
                    self.send_error(404)
                    return
                body = render_openmetrics(registry).encode()
                self.send_response(200)
                self.send_header("Content-Type", CONTENT_TYPE)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                # wfile is this connection's own socket: one handler
                # instance per request, so the per-connection threads
                # the race detector pairs here never share it
                self.wfile.write(body)  # tpumt: ignore[TPM1601]

            def log_message(self, *args):  # scrapes must not spam stdout
                pass

        self._server = ThreadingHTTPServer((self._host, self.port),
                                           Handler)
        self._server.daemon_threads = True
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="tpumt-metrics",
            daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        server, self._server = self._server, None
        if server is not None:
            server.shutdown()
            server.server_close()


class Heartbeat:
    """Periodic ``kind: "health" event: "heartbeat"`` records through
    ``sink``. Runs on its own daemon thread so a wedged main thread
    still leaves a trail — which is precisely how the online doctor
    tells a straggling rank (heartbeats keep coming, phases lag) from a
    dead one (heartbeats stop)."""

    def __init__(self, registry: MetricsRegistry,
                 sink: Callable[[dict], None],
                 interval_s: float = 1.0):
        self._registry = registry
        self._sink = sink
        self._interval = max(0.05, float(interval_s))
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._seq = 0

    def _record(self, final: bool = False) -> dict:
        reg = self._registry
        # a monotonic counter bump whose only off-thread caller is
        # stop(), which joins the heartbeat thread before its final
        # emit: ordered by happens-before, not by a lock
        self._seq += 1  # tpumt: ignore[TPM1601]
        rec = {
            "kind": "health", "event": "heartbeat", "seq": self._seq,
            "t": reg.wall(),
            "uptime_s": round(reg.wall() - reg.started_wall, 3),
        }
        if final:
            rec["final"] = True
        snap = reg.snapshot()

        def total(name):
            fam = snap.get(name)
            return sum(v for _l, v in fam["samples"]) if fam else None

        def gauge_max(name):
            fam = snap.get(name)
            return max((v for _l, v in fam["samples"]), default=None) \
                if fam else None

        records = total("tpumt_records")
        if records is not None:
            rec["records"] = int(records)
        depth = total("tpumt_serve_queue_depth")
        if depth is not None:
            rec["queue_depth"] = int(depth)
        hbm = gauge_max("tpumt_hbm_bytes_in_use")
        if hbm is None:
            hbm = gauge_max("tpumt_live_bytes")
        if hbm is not None:
            rec["hbm_bytes_in_use"] = int(hbm)
        lat = snap.get("tpumt_latency_seconds")
        if lat and lat["samples"]:
            _labels, q = lat["samples"][0]
            if q["count"]:
                rec["p50_ms"] = round(q["p50"] * 1e3, 3)
                rec["p99_ms"] = round(q["p99"] * 1e3, 3)
        return rec

    def _emit(self, final: bool = False) -> None:
        try:
            self._sink(self._record(final=final))
        except Exception:
            pass  # the heartbeat must never hurt the run it watches

    def _run(self) -> None:
        while not self._stop.wait(self._interval):
            self._emit()

    def start(self) -> "Heartbeat":
        self._thread = threading.Thread(
            target=self._run, name="tpumt-heartbeat", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
        self._emit(final=True)  # the clean-close marker heartbeat

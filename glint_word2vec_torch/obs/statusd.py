"""Live run inspection, ported from ``glint_word2vec_tpu/obs/statusd.py``: a
read-only HTTP status endpoint for one trainer, one embedding service, one fleet router
or one training supervisor.

``config.status_port > 0`` starts this server for the duration of a fit. Routes (GET
only):

- ``/`` or ``/status.json``: the gauge snapshot as JSON (``Trainer.status_snapshot()``);
- ``/metrics``: its scalar gauges in the Prometheus text format (the JAX package's
  ``glint_*`` names for a trainer, ``glint_serve_*`` for a service,
  ``glint_serve_fleet_*`` for a fleet's router, ``glint_supervisor_*`` for a
  supervisor);
- ``/healthz``: ``200 ok``.

One ``HTTPServer`` on one daemon thread, bound to 127.0.0.1. The snapshot callable
reads plain host attributes and bounded rings that the trainer already fetched: it
never touches a CUDA tensor, so a scrape can never synchronise the card from a second
thread in the middle of a dispatch. Off by default, and then no thread and no socket.
"""

from __future__ import annotations

import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, HTTPServer
from typing import Callable, Optional

logger = logging.getLogger("glint_word2vec_torch")

_POLL_S = 0.05  # how often the server thread checks for stop()


def _gauge(lines: list, name: str, value, labels: str = "",
           seen: Optional[set] = None) -> None:
    """Append one gauge sample (``# TYPE`` line and sample) to ``lines``; None skips,
    bools render as 0/1. With ``seen``, a name's ``# TYPE`` line is written at its first
    sample only (the text format forbids a second one; the fleet's per-replica labels
    give one name many samples)."""
    if value is None:
        return
    if isinstance(value, bool):
        value = float(value)
    if seen is None or name not in seen:
        lines.append(f"# TYPE {name} gauge")
        if seen is not None:
            seen.add(name)
    lines.append(f"{name}{labels} {float(value):g}")


def prometheus_text(snap: dict) -> str:
    """A status snapshot's scalar gauges in the Prometheus text format: scalar fields
    as ``glint_<field>``, the norm channels as ``glint_norm_<channel>{matrix=...}``,
    the phase rollups as ``glint_phase_seconds_total``/``glint_phase_count``/
    ``glint_phase_p99_seconds{phase=...}``."""
    lines: list = []
    for field in ("global_step", "words", "pairs_trained", "pairs_per_sec", "alpha",
                  "lr_scale", "recoveries", "rollbacks", "watchdog_fires",
                  "heartbeats", "host_wait_s_total", "dispatch_s_total"):
        _gauge(lines, f"glint_{field}", snap.get(field))
    _gauge(lines, "glint_running", 1.0 if snap.get("status") == "running" else 0.0)
    norms = snap.get("norms") or {}
    for matrix in ("syn0", "syn1"):
        ch = norms.get(matrix) or {}
        for channel in ("max_norm", "mean_norm", "p99_norm", "frac_over"):
            if channel in ch:
                _gauge(lines, f"glint_norm_{channel}", ch[channel],
                       f'{{matrix="{matrix}"}}')
    for phase, ph in (snap.get("phases") or {}).items():
        lab = f'{{phase="{phase}"}}'
        _gauge(lines, "glint_phase_seconds_total", ph.get("total_s"), lab)
        _gauge(lines, "glint_phase_count", ph.get("count"), lab)
        _gauge(lines, "glint_phase_p99_seconds", ph.get("p99_s"), lab)
    return "\n".join(lines) + "\n"


def serve_prometheus_text(snap: dict) -> str:
    """A serving snapshot (``serve.EmbeddingService.status_snapshot``) in the
    Prometheus text format: the JAX package's ``glint_serve_*`` names (batcher counters
    and gauges, latency quantiles over the recent ring, hot-reload counts, the live
    index's measured recall and footprint)."""
    lines: list = []
    _gauge(lines, "glint_serve_up", 1.0 if snap.get("status") == "serving" else 0.0)
    for field in ("submitted", "refused", "completed", "errors", "batches",
                  "reloads", "models_released"):
        _gauge(lines, f"glint_serve_{field}_total", snap.get(field))
    for field in ("queue_depth", "occupancy_mean", "vocab_size", "load_seconds"):
        _gauge(lines, f"glint_serve_{field}", snap.get(field))
    lat = snap.get("latency_ms") or {}
    for q in ("p50", "p95", "p99"):
        if q in lat:
            _gauge(lines, "glint_serve_latency_ms", lat[q], f'{{quantile="{q}"}}')
    ann = snap.get("ann") or {}
    for field in ("recall_at_10", "nprobe", "centroids", "build_seconds",
                  "bytes_per_vector"):
        if field in ann:
            _gauge(lines, f"glint_serve_ann_{field}", ann[field])
    if "index_bytes" in ann:
        _gauge(lines, "glint_serve_index_bytes", ann["index_bytes"])
    return "\n".join(lines) + "\n"


# a breaker's state as an ordered gauge: closed is healthy, open is worst
_BREAKER_GAUGE = {"closed": 0, "half-open": 1, "open": 2}


def fleet_prometheus_text(snap: dict) -> str:
    """A fleet snapshot (``serve.fleet.FleetRouter.status_snapshot``) in the Prometheus
    text format: the JAX package's fleet-level ``glint_serve_fleet_*`` gauges (the SLO
    block among them, named by ``obs/slo.slo_gauge_lines``), and each replica's own
    ``glint_serve_*`` gauges under a ``replica`` label, so one scrape of the router sees
    the whole fleet."""
    from glint_word2vec_torch.obs.slo import slo_gauge_lines

    lines: list = []
    seen: set = set()

    def gauge(name: str, value, labels: str = "") -> None:
        _gauge(lines, name, value, labels, seen=seen)

    gauge("glint_serve_fleet_up", 1.0 if snap.get("status") == "serving" else 0.0)
    for field in ("queries", "failures", "retries", "hedges", "hedge_wins",
                  "shed_single", "shed_bulk", "reload_rounds"):
        gauge(f"glint_serve_fleet_{field}_total", snap.get(field))
    for field in ("healthy", "degraded", "min_serving_during_reloads"):
        gauge(f"glint_serve_fleet_{field}", snap.get(field))
    lat = snap.get("latency_ms") or {}
    for q in ("p50", "p95", "p99"):
        if q in lat:
            gauge("glint_serve_fleet_latency_ms", lat[q], f'{{quantile="{q}"}}')
    slo_gauge_lines(gauge, snap.get("slo") or {})
    fleet_index_bytes = 0
    fleet_index_replicas = 0
    for name, rep in (snap.get("replicas") or {}).items():
        lab = f'{{replica="{name}"}}'
        gauge("glint_serve_fleet_breaker_state", _BREAKER_GAUGE.get(rep.get("state")),
              lab)
        gauge("glint_serve_up", rep.get("alive"), lab)
        gauge("glint_serve_fleet_degraded_replica", rep.get("degraded"), lab)
        gauge("glint_serve_fleet_in_flight", rep.get("in_flight"), lab)
        gauge("glint_serve_fleet_restarts_total", rep.get("restarts"), lab)
        gauge("glint_serve_fleet_reloads_total", rep.get("reloads"), lab)
        # the replica's own gauges, from the prober's cached stats op (absent while
        # the replica is down)
        stats = rep.get("stats") or {}
        for field in ("submitted", "refused", "completed", "errors", "batches",
                      "reloads", "models_released"):
            gauge(f"glint_serve_{field}_total", stats.get(field), lab)
        for field in ("queue_depth", "occupancy_mean", "vocab_size", "load_seconds"):
            gauge(f"glint_serve_{field}", stats.get(field), lab)
        slat = stats.get("latency_ms") or {}
        for q in ("p50", "p95", "p99"):
            if q in slat:
                gauge("glint_serve_latency_ms", slat[q],
                      f'{{replica="{name}",quantile="{q}"}}')
        ann = stats.get("ann") or {}
        for field in ("recall_at_10", "nprobe", "centroids", "bytes_per_vector"):
            if field in ann:
                gauge(f"glint_serve_ann_{field}", ann[field], lab)
        if "index_bytes" in ann:
            gauge("glint_serve_index_bytes", ann["index_bytes"], lab)
            fleet_index_bytes += ann["index_bytes"]
            fleet_index_replicas += 1
    # every replica holds its own copy of the index: the sum is what the fleet pays
    if fleet_index_replicas:
        gauge("glint_serve_fleet_index_bytes", fleet_index_bytes)
    return "\n".join(lines) + "\n"


def supervisor_prometheus_text(snap: dict) -> str:
    """A supervisor snapshot (``train.supervisor.TrainingSupervisor.status_snapshot``)
    in the Prometheus text format: the JAX package's ``glint_supervisor_*`` names
    (restart, stall and preempt counters, the escalation ladder's stage, the
    quarantine latch, the gang's last observed step and live children)."""
    lines: list = []
    _gauge(lines, "glint_supervisor_up", snap.get("up"))
    for field in ("attempts", "restarts", "stalls", "preempts"):
        _gauge(lines, f"glint_supervisor_{field}_total", snap.get(field))
    for field in ("ladder_stage", "quarantined", "last_step", "child_up"):
        _gauge(lines, f"glint_supervisor_{field}", snap.get(field))
    return "\n".join(lines) + "\n"


class _Handler(BaseHTTPRequestHandler):
    snapshot_fn: Callable[[], dict]  # set per server by StatusServer.start
    metrics_fn: Callable[[dict], str]

    def _send(self, code: int, body: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self) -> None:  # noqa: N802 (http.server's name)
        path = self.path.split("?", 1)[0]
        try:
            if path in ("/", "/status.json"):
                self._send(200, json.dumps(self.snapshot_fn()).encode(),
                           "application/json")
            elif path == "/metrics":
                self._send(200, self.metrics_fn(self.snapshot_fn()).encode(),
                           "text/plain; version=0.0.4; charset=utf-8")
            elif path == "/healthz":
                self._send(200, b"ok\n", "text/plain")
            else:
                self._send(404, b"not found\n", "text/plain")
        except (BrokenPipeError, ConnectionResetError):
            pass  # the scraper went away mid-response

    def log_message(self, fmt: str, *args) -> None:
        logger.debug("statusd: %s", fmt % args)


class StatusServer:
    """One localhost HTTP server serving a snapshot callable, read-only."""

    def __init__(self, port: int, snapshot_fn: Callable[[], dict],
                 metrics_fn: Optional[Callable[[dict], str]] = None):
        """``metrics_fn`` renders ``/metrics``: the trainer's gauges by default, the
        serving tier passes :func:`serve_prometheus_text`."""
        self._requested_port = int(port)
        self._snapshot_fn = snapshot_fn
        self._metrics_fn = metrics_fn or prometheus_text
        self._server: Optional[HTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        """The bound port (the requested one, unless 0 asked for an ephemeral
        port)."""
        return self._server.server_address[1] if self._server else 0

    def start(self) -> "StatusServer":
        handler = type("_BoundHandler", (_Handler,),
                       {"snapshot_fn": staticmethod(self._snapshot_fn),
                        "metrics_fn": staticmethod(self._metrics_fn)})
        self._server = HTTPServer(("127.0.0.1", self._requested_port), handler)
        # serve_forever checks for shutdown once per poll: at the default 0.5 s, the
        # end of every fit with the endpoint on waited up to half a second in stop()
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        kwargs={"poll_interval": _POLL_S},
                                        name="glint-statusd", daemon=True)
        self._thread.start()
        logger.info("statusd listening on 127.0.0.1:%d (/status.json, /metrics, "
                    "/healthz)", self.port)
        return self

    def stop(self) -> int:
        """Stop serving; returns the number of leaked threads (0 or 1)."""
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
        leaked = 0
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5)
            if t.is_alive():
                leaked = 1
                logger.warning("statusd server thread leaked (join timeout)")
        return leaked

"""Prometheus metrics + observability HTTP endpoint.

The port's copy of ``selkies_tpu/observability/metrics.py``: the same
series under the same names (a contract with dashboards and
docs/observability.md; ``tpu_utilization`` and its ``gpu_utilization``
alias keep their names). ``/debug/jax-trace`` keeps its route and its
``jax_trace_enabled`` setting and runs a ``torch.profiler`` capture
(observability/tracing.py).

Parity with ``legacy/metrics.py:39-75``: ``fps`` gauge, ``fps_hist``
histogram, ``gpu_utilization`` (the encoders' duty estimate), ``latency``
gauge, and a ``webrtc_statistics`` Info — plus tpuenc-specific series
(encode ms, stripe bytes, backpressure state) and the flight-recorder
stage series (docs/observability.md). Falls back to a no-op registry
when prometheus_client is unavailable so the server never grows a hard
dependency.

The HTTP side is our own threaded server rather than
``prometheus_client.start_http_server`` because the port carries more
than the exposition: ``/healthz`` (liveness), ``/debug/trace`` (the
flight recorder's Perfetto-loadable capture of the last N seconds) and
``/debug/jax-trace`` (an on-demand profiler capture, guarded by
the ``jax_trace_enabled`` setting). A bind failure logs and disables
the endpoint — it never takes the data server down with it.

Every series registered here must be documented in
docs/observability.md; tools/metrics_lint.py (tier-1) enforces the
correspondence in both directions.
"""

from __future__ import annotations

import json
import logging
import os
import tempfile
import threading
from typing import Dict, Optional

logger = logging.getLogger("selkies_tpu_torch.observability.metrics")

try:
    import prometheus_client as prom
    from prometheus_client import (CollectorRegistry, Counter, Gauge,
                                   Histogram, Info)
    HAVE_PROM = True
except Exception:  # pragma: no cover
    HAVE_PROM = False


class Metrics:
    def __init__(self, port: int = 8000):
        self.port = port
        self._started = False
        self._httpd = None
        self._http_thread = None
        #: actual bound port once start_http succeeds (port=0 binds
        #: ephemeral — tests use this)
        self.http_port: Optional[int] = None
        #: the server's FlightRecorder, wired by main()/bench so
        #: /debug/trace can export it (None -> endpoint answers 503)
        self.recorder = None
        #: /debug/jax-trace is an on-demand profiler with filesystem
        #: side effects: disabled unless the operator opts in
        #: (jax_trace_enabled setting); on the port it is a
        #: torch.profiler capture
        self.jax_trace_enabled = False
        if not HAVE_PROM:  # pragma: no cover
            return
        self.registry = CollectorRegistry()
        self.fps = Gauge("fps", "Frames per second observed by client",
                         registry=self.registry)
        self.fps_hist = Histogram(
            "fps_hist", "Histogram of FPS observed by client",
            buckets=(0, 10, 20, 30, 40, 50, 60, 90, 120, float("inf")),
            registry=self.registry)
        self.latency = Gauge("latency", "Latency observed by client (ms)",
                             registry=self.registry)
        self.tpu_utilization = Gauge(
            "tpu_utilization", "TPU encode duty cycle percent",
            registry=self.registry)
        self.gpu_utilization = Gauge(
            "gpu_utilization", "Alias of tpu_utilization for dashboards "
            "built against the reference", registry=self.registry)
        self.encode_ms = Histogram(
            "tpuenc_encode_ms", "Per-frame encode wall time (ms)",
            buckets=(1, 2, 4, 8, 16, 33, 66, 100, float("inf")),
            registry=self.registry)
        self.frame_bytes = Histogram(
            "tpuenc_frame_bytes", "Encoded bytes per frame",
            buckets=(1e3, 5e3, 2e4, 5e4, 1e5, 2.5e5, 1e6, float("inf")),
            registry=self.registry)
        # the H.264 bottleneck claims (D2H transfer size, host
        # entropy cost per session) must be measured, not inferred — the
        # pipelined encoders record these per frame
        self.d2h_bytes_per_frame = Gauge(
            "tpuenc_d2h_bytes_per_frame", "Device-to-host bytes fetched "
            "per encoded frame (heads, payloads, and overflow re-reads)",
            registry=self.registry)
        self.host_entropy_ms_per_frame = Gauge(
            "tpuenc_host_entropy_ms_per_frame", "Host-side entropy-coding "
            "wall time per frame (native CAVLC / overflow fallbacks; ~0 "
            "when the device entropy tiers carry steady state)",
            registry=self.registry)
        # the dispatch/fetch-floor claims must stay measured —
        # the async pipeline driver keeps >=2 batches in flight, and
        # these series prove (or disprove) it per deployment
        self.inflight_batches = Gauge(
            "tpuenc_inflight_batches", "Encode batches dispatched but not "
            "yet harvested (the async pipeline keeps >=2 in flight so the "
            "chip never waits on a host round trip)",
            registry=self.registry)
        self.dispatch_ms = Histogram(
            "tpuenc_dispatch_ms", "Host wall time to stage + dispatch one "
            "encode batch (program launch, not device compute)",
            buckets=(0.5, 1, 2, 4, 8, 16, 33, 66, 100, 250, float("inf")),
            registry=self.registry)
        self.fetch_wait_ms = Histogram(
            "tpuenc_fetch_wait_ms", "Host wall time blocked materializing "
            "an eagerly-started D2H fetch (~0 when the overlap hides the "
            "transfer; the RPC floor when it does not)",
            buckets=(0.5, 1, 2, 4, 8, 16, 33, 66, 100, 250, float("inf")),
            registry=self.registry)
        # supervision / degradation observability — dropped and
        # errored frames were previously log lines only; restart and ladder
        # activity must be scrapeable to be actionable
        self.frames_dropped = Counter(
            "frames_dropped_total", "Frames dropped by saturated or "
            "errored encode pipelines", registry=self.registry)
        self.encode_errors = Counter(
            "encode_errors_total", "Frames lost to encoder exceptions",
            registry=self.registry)
        self.watchdog_restarts = Counter(
            "watchdog_restarts_total", "Pipeline restarts triggered by the "
            "frame-deadline watchdog (stalled capture/fetch)",
            registry=self.registry)
        self.supervisor_restarts = Counter(
            "supervisor_restarts_total", "Supervised restarts of display "
            "capture/backpressure loops (crash + watchdog + clean)",
            registry=self.registry)
        self.degradation_rung = Gauge(
            "degradation_rung", "Worst degradation-ladder rung across "
            "displays (0 device entropy, 1 host entropy, 2 jpeg fallback)",
            registry=self.registry)
        self.failed_displays = Gauge(
            "failed_displays", "Displays whose supervisor exhausted its "
            "restart budget (terminal failed state)",
            registry=self.registry)
        # wire-edge hardening — malformed/floody/stalled clients
        # must be visible as first-class series, not debug log lines
        self.protocol_errors = Counter(
            "protocol_errors_total", "Client messages dropped by the "
            "per-message exception boundary (malformed frames, spoofed "
            "server verbs, handler crashes)", registry=self.registry)
        self.rate_limited = Counter(
            "rate_limited_total", "Client messages dropped by per-class "
            "token-bucket rate limiting", ("klass",),
            registry=self.registry)
        self.upload_paced = Counter(
            "upload_paced_total", "Upload messages accepted after a "
            "pacing sleep (byte-rate smoothing; nothing was dropped)",
            registry=self.registry)
        self.sessions_rejected = Counter(
            "sessions_rejected_total", "Connections/displays refused by "
            "admission control (max_clients, max_displays, load shedding)",
            registry=self.registry)
        self.slow_client_evictions = Counter(
            "slow_client_evictions_total", "Clients disconnected after "
            "sustained send-queue overflow (KILL slow_consumer)",
            registry=self.registry)
        self.send_queue_depth = Gauge(
            "send_queue_depth", "Deepest per-client bounded send queue",
            registry=self.registry)
        self.reconfigure_coalesced = Counter(
            "reconfigure_coalesced_total", "Resize/SETTINGS requests "
            "absorbed into an already-scheduled display reconfiguration",
            registry=self.registry)
        self.sessions_queued = Counter(
            "sessions_queued_total", "Display joins that waited in the "
            "admission queue for a scheduler slot (admit-after-wait and "
            "shed-after-wait both count)", registry=self.registry)
        # session-scheduler health — the coordinator's per-slot
        # fault domains were stats()-only before; a sick slot, a
        # quarantine, or a live migration must be scrapeable
        # (docs/scaling.md). Cumulative values are mirrored from the
        # coordinator as gauges (the coordinator owns the counters).
        self.mesh_active_sessions = Gauge(
            "mesh_active_sessions", "Sessions attached to mesh scheduler "
            "slots across all geometry buckets", registry=self.registry)
        self.mesh_lanes = Gauge(
            "mesh_lanes", "Live batch lanes across all geometry buckets "
            "(each lane is one compiled SPMD encoder)",
            registry=self.registry)
        self.mesh_inflight_batches = Gauge(
            "mesh_inflight_batches", "Mesh ticks dispatched but not yet "
            "harvested, summed over lanes", registry=self.registry)
        self.mesh_slot_errors = Gauge(
            "mesh_slot_errors_total", "Frames lost to failed mesh "
            "dispatch/harvest ticks, summed over slots (cumulative; "
            "per-slot detail rides the system_health feed)",
            registry=self.registry)
        self.mesh_tick_errors = Gauge(
            "mesh_tick_errors_total", "Failed mesh coordinator ticks "
            "(cumulative, lane-contained failures included)",
            registry=self.registry)
        self.mesh_worker_restarts = Gauge(
            "mesh_worker_restarts_total", "Mesh tick-thread re-spawns "
            "after a worker death (cumulative)", registry=self.registry)
        self.mesh_quarantined_slots = Gauge(
            "mesh_quarantined_slots", "Scheduler slots removed from "
            "service as sick fault domains", registry=self.registry)
        self.mesh_migrations = Gauge(
            "mesh_sessions_migrated_total", "Sessions live-migrated off "
            "quarantined slots onto healthy lanes (cumulative)",
            registry=self.registry)
        # split-frame encoding — one 4K/8K frame's stripe
        # bands sharded across chips; the shard fan-out and the
        # host-side slice-concat wall must be scrapeable
        self.sfe_shards_g = Gauge(
            "sfe_shards", "Stripe shards one frame spans on the widest "
            "active split-frame-encoding lane (0 = no SFE lanes)",
            registry=self.registry)
        self.sfe_concat_ms = Gauge(
            "sfe_concat_ms", "Host wall per mesh tick concatenating "
            "per-shard slice payloads into access units on SFE lanes "
            "(recent p50, mirrored from the coordinator)",
            registry=self.registry)
        # flight-recorder stage series — the per-stage latency
        # decomposition behind the glass-to-glass number, labeled by
        # display so a sick session is attributable (docs/observability.md)
        _stage_buckets = (0.25, 0.5, 1, 2, 4, 8, 16, 33, 66, 100, 250,
                         500, 1000, float("inf"))
        self.frame_stage_ms = Histogram(
            "frame_stage_ms", "Per-frame wall time in one pipeline stage "
            "(capture/stage/dispatch/fetch_wait/pack/queue/send/ack)",
            ("stage", "display"), buckets=_stage_buckets,
            registry=self.registry)
        self.glass_to_glass_ms = Histogram(
            "glass_to_glass_ms", "Capture start to CLIENT_FRAME_ACK per "
            "acked frame (the latency the user feels)",
            ("display",), buckets=_stage_buckets, registry=self.registry)
        self.encode_only_ms = Histogram(
            "encode_only_ms", "Submit to stripes-host-packed per frame "
            "(the ROADMAP item 1 criterion vs device ms/frame)",
            ("display",), buckets=_stage_buckets, registry=self.registry)
        self.trace_open_spans = Gauge(
            "trace_open_spans", "Frame spans opened but not yet terminal "
            "(a steady nonzero residue means a span leak)",
            registry=self.registry)
        self.trace_dropped = Counter(
            "trace_dropped_total", "Frame spans closed with a dropped@/"
            "expired@ terminal mark, by the stage that lost them",
            ("stage",), registry=self.registry)
        self.clients = Gauge("connected_clients", "WebSocket clients",
                             registry=self.registry)
        self.backpressured = Gauge(
            "backpressured_displays", "Displays currently throttled by the "
            "frame-ACK backpressure loop", registry=self.registry)
        self.webrtc_stats = Info("webrtc_statistics", "Last WebRTC stats",
                                 registry=self.registry)

    def start_http(self) -> bool:
        """Expose /metrics + /healthz + /debug/trace [+ /debug/jax-trace]
        (parity with legacy Metrics.start_http, plus the observability
        surface). A bind failure is NON-FATAL: it logs, leaves the
        endpoint disabled, and returns False — a busy metrics port must
        never crash the data server."""
        if self._started:
            return True
        from http.server import ThreadingHTTPServer

        if self.jax_trace_enabled:
            # the profiler route's captures run in the server's threads
            from .tracing import prepare_profiler_trace

            try:
                prepare_profiler_trace()
            except Exception as e:
                logger.warning("profiler route unprepared: %s", e)

        try:
            self._httpd = ThreadingHTTPServer(
                ("0.0.0.0", int(self.port)),
                _make_observability_handler())
        except OSError as e:
            logger.error("metrics http bind failed on :%s (%s); metrics "
                         "endpoint disabled", self.port, e)
            self._httpd = None
            return False
        self._httpd.daemon_threads = True
        self._httpd.metrics = self
        self.http_port = self._httpd.server_address[1]
        self._http_thread = threading.Thread(
            target=self._httpd.serve_forever, name="metrics-http",
            daemon=True)
        self._http_thread.start()
        self._started = True
        logger.info("observability http on :%d (/metrics /healthz "
                    "/debug/trace%s)", self.http_port,
                    " /debug/jax-trace" if self.jax_trace_enabled else "")
        return True

    def stop_http(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
            self._started = False

    # no-op-safe setters -------------------------------------------------

    def set_fps(self, fps: float) -> None:
        if HAVE_PROM:
            self.fps.set(fps)
            self.fps_hist.observe(fps)

    def set_latency(self, ms: float) -> None:
        if HAVE_PROM:
            self.latency.set(ms)

    def set_tpu_utilization(self, pct: float) -> None:
        if HAVE_PROM:
            self.tpu_utilization.set(pct)
            self.gpu_utilization.set(pct)

    def observe_encode(self, ms: float, nbytes: int) -> None:
        if HAVE_PROM:
            self.encode_ms.observe(ms)
            self.frame_bytes.observe(nbytes)

    def set_d2h_bytes_per_frame(self, nbytes: float) -> None:
        if HAVE_PROM:
            self.d2h_bytes_per_frame.set(nbytes)

    def set_host_entropy_ms_per_frame(self, ms: float) -> None:
        if HAVE_PROM:
            self.host_entropy_ms_per_frame.set(ms)

    def set_inflight_batches(self, n: int) -> None:
        if HAVE_PROM:
            self.inflight_batches.set(n)

    def observe_dispatch(self, ms: float) -> None:
        if HAVE_PROM:
            self.dispatch_ms.observe(ms)

    def observe_fetch_wait(self, ms: float) -> None:
        if HAVE_PROM:
            self.fetch_wait_ms.observe(ms)

    def observe_stage(self, display: str, stage: str, ms: float) -> None:
        if HAVE_PROM:
            self.frame_stage_ms.labels(stage=stage, display=display) \
                .observe(ms)

    def observe_glass_to_glass(self, display: str, ms: float) -> None:
        if HAVE_PROM:
            self.glass_to_glass_ms.labels(display=display).observe(ms)

    def observe_encode_only(self, display: str, ms: float) -> None:
        if HAVE_PROM:
            self.encode_only_ms.labels(display=display).observe(ms)

    def set_trace_open_spans(self, n: int) -> None:
        if HAVE_PROM:
            self.trace_open_spans.set(n)

    def inc_trace_dropped(self, stage: str, n: int = 1) -> None:
        if HAVE_PROM and n > 0:
            self.trace_dropped.labels(stage=stage).inc(n)

    def inc_frames_dropped(self, n: int = 1) -> None:
        if HAVE_PROM and n > 0:
            self.frames_dropped.inc(n)

    def inc_encode_errors(self, n: int = 1) -> None:
        if HAVE_PROM and n > 0:
            self.encode_errors.inc(n)

    def inc_watchdog_restart(self) -> None:
        if HAVE_PROM:
            self.watchdog_restarts.inc()

    def inc_supervisor_restart(self) -> None:
        if HAVE_PROM:
            self.supervisor_restarts.inc()

    def set_degradation_rung(self, level: int) -> None:
        if HAVE_PROM:
            self.degradation_rung.set(level)

    def set_failed_displays(self, n: int) -> None:
        if HAVE_PROM:
            self.failed_displays.set(n)

    def inc_protocol_errors(self, n: int = 1) -> None:
        if HAVE_PROM and n > 0:
            self.protocol_errors.inc(n)

    def inc_rate_limited(self, klass: str, n: int = 1) -> None:
        if HAVE_PROM and n > 0:
            self.rate_limited.labels(klass=klass).inc(n)

    def inc_upload_paced(self, n: int = 1) -> None:
        if HAVE_PROM and n > 0:
            self.upload_paced.inc(n)

    def inc_sessions_rejected(self) -> None:
        if HAVE_PROM:
            self.sessions_rejected.inc()

    def inc_slow_client_eviction(self) -> None:
        if HAVE_PROM:
            self.slow_client_evictions.inc()

    def set_send_queue_depth(self, n: int) -> None:
        if HAVE_PROM:
            self.send_queue_depth.set(n)

    def inc_reconfigure_coalesced(self, n: int = 1) -> None:
        if HAVE_PROM and n > 0:
            self.reconfigure_coalesced.inc(n)

    def inc_sessions_queued(self) -> None:
        if HAVE_PROM:
            self.sessions_queued.inc()

    def set_mesh_health(self, *, active_sessions: int, lanes: int,
                        inflight: int, slot_errors: int, tick_errors: int,
                        worker_restarts: int, quarantined: int,
                        migrations: int) -> None:
        """Mirror the session scheduler's aggregate health (stats tick)."""
        if not HAVE_PROM:
            return
        self.mesh_active_sessions.set(active_sessions)
        self.mesh_lanes.set(lanes)
        self.mesh_inflight_batches.set(inflight)
        self.mesh_slot_errors.set(slot_errors)
        self.mesh_tick_errors.set(tick_errors)
        self.mesh_worker_restarts.set(worker_restarts)
        self.mesh_quarantined_slots.set(quarantined)
        self.mesh_migrations.set(migrations)

    def set_sfe_health(self, *, shards: int,
                       concat_ms_p50: float) -> None:
        """Mirror the SFE lane fan-out + slice-concat wall (stats tick)."""
        if HAVE_PROM:
            self.sfe_shards_g.set(shards)
            self.sfe_concat_ms.set(concat_ms_p50)

    def set_clients(self, n: int) -> None:
        if HAVE_PROM:
            self.clients.set(n)

    def set_backpressured(self, n: int) -> None:
        if HAVE_PROM:
            self.backpressured.set(n)

    def set_webrtc_stats(self, stats: Dict[str, str]) -> None:
        if HAVE_PROM:
            self.webrtc_stats.info(
                {str(k): str(v) for k, v in stats.items()})

    def render(self) -> bytes:
        """Current exposition text (for tests / ad-hoc scraping)."""
        if not HAVE_PROM:  # pragma: no cover
            return b""
        return prom.generate_latest(self.registry)


# ---------------------------------------------------------------------------
# the observability HTTP endpoint


def _make_observability_handler():
    from http.server import BaseHTTPRequestHandler
    from urllib.parse import parse_qs, urlparse

    class Handler(BaseHTTPRequestHandler):
        server_version = "selkies-tpu-observability"

        def _reply(self, code: int, body: bytes,
                   ctype: str = "text/plain; charset=utf-8") -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            try:
                self.wfile.write(body)
            except (BrokenPipeError, ConnectionResetError):
                pass

        def log_message(self, fmt, *args):  # quiet: scrapes are periodic
            logger.debug("http %s", fmt % args)

        def do_GET(self):  # noqa: N802 (http.server API)
            m: Metrics = self.server.metrics
            url = urlparse(self.path)
            q = parse_qs(url.query)
            try:
                if url.path == "/healthz":
                    self._reply(200, b"ok\n")
                elif url.path == "/metrics" or url.path == "/":
                    self._reply(200, m.render() if m else b"",
                                "text/plain; version=0.0.4; charset=utf-8")
                elif url.path == "/debug/trace":
                    rec = m.recorder if m else None
                    if rec is None:
                        self._reply(503, b"no flight recorder attached\n")
                        return
                    last_s = float(q.get("s", ["30"])[0])
                    body = json.dumps(rec.export_trace_events(
                        last_s=last_s)).encode()
                    self._reply(200, body, "application/json")
                elif url.path == "/debug/jax-trace":
                    # the JAX package's route and setting; on the port
                    # it is a torch.profiler capture
                    if not (m and m.jax_trace_enabled):
                        self._reply(
                            403, b"profiler tracing disabled; set "
                            b"jax_trace_enabled=true on the server\n")
                        return
                    import shutil

                    from .tracing import capture_profiler_trace

                    ms = float(q.get("ms", ["500"])[0])
                    # one fixed dir, pruned per capture: a polling
                    # client must not accumulate profile dumps until
                    # the disk fills (captures can be tens of MB)
                    out_dir = os.path.join(tempfile.gettempdir(),
                                           "selkies_torch_trace")
                    shutil.rmtree(out_dir, ignore_errors=True)
                    os.makedirs(out_dir, exist_ok=True)
                    info = capture_profiler_trace(out_dir, ms)
                    self._reply(200, json.dumps(info).encode(),
                                "application/json")
                else:
                    self._reply(404, b"not found\n")
            except Exception as e:
                logger.exception("observability endpoint %s failed",
                                 url.path)
                self._reply(500, f"error: {e!r}\n".encode())

    return Handler

"""The WebSocket data server of the websockets mode.

Counterpart of ``selkies_tpu/server/data_server.py``. What the port serves:

* the ``ws_handler`` handshake — ``SETTINGS,{json}`` in; ``MODE
  websockets``, the last cursor (``cursor,{json}``, when the app has one)
  and the ``server_settings`` JSON out;
* each display's capture loop: source frames → the encoder's
  ``try_submit``/``poll`` → 0x03 JPEG stripes, 0x04 H.264 stripes for
  ``x264enc-striped`` or 0x00 full frames for ``x264enc``, fanned out to
  the display's viewers;
* the wire edge: every server → client message after the handshake rides
  the client's bounded send queue (drop-oldest video, never-drop control;
  a consumer saturated for ``slow_client_evict_s`` gets ``KILL
  slow_consumer``); a connection past ``max_clients`` or while the server
  is load shedding gets ``KILL server_full``; each connection's
  :class:`~..robustness.ConnectionGuard` rate-limits its message classes
  and charges malformed messages to an error budget whose exhaustion ends
  in ``KILL protocol_abuse``; ``edge_stats`` counts all of it;
* client binary messages: 0x01 file chunks into the open upload (paced
  through the upload bucket, capped by ``max_upload_mb``; ``FILE_UPLOAD_*``
  with path sanitizing under ``SELKIES_UPLOAD_DIR``), 0x02 microphone
  chunks (capped by ``max_mic_chunk_kb`` and rate-limited, then handed
  to the audio pipeline's ``on_mic_data`` when one is wired), anything
  else rejected;
* resize and reconfigure: ``r,<W>x<H>`` from a display's owner and every
  ``SETTINGS`` schedule one debounced reconfiguration
  (``resize_debounce_ms``; a storm coalesces), which lays the displays out
  (``display/``; xrandr where the host has it) and restarts the pipelines
  whose geometry or settings changed; ``s,<scale>`` sets the DPI;
* supervision (``robustness/``): each display's capture and backpressure
  loops run under a :class:`~..robustness.Supervisor`; encoder failures
  step the display's :class:`~..robustness.DegradationLadder` (device →
  host → jpeg, every rung on the card) and a clean window probes it back
  up; a display whose budget runs out fails alone; fault points
  (``SELKIES_TPU_FAULTS``) are checked at the JAX server's call sites;
* ``CLIENT_FRAME_ACK`` and ``_f`` into the display's
  :class:`~.backpressure.BackpressureState`; ``START_VIDEO``/
  ``STOP_VIDEO``; ``START_AUDIO``/``STOP_AUDIO`` start and stop the audio
  pipeline (``audio_pipeline``, wired by ``main``; it also starts with
  the first client and stops with the last); ``cmd`` when
  ``command_enabled``; ``SET_NATIVE_CURSOR_RENDERING``; other verbs go to
  ``input_handler`` when one is set;
* the flight recorder (``recorder``, observability/tracing.py): every
  captured frame opens a span, the encoder's stage intervals are folded
  in at harvest (``pop_trace``), the frame's last stripe rides the
  owner's send queue traced (``queue``/``send``), and CLIENT_FRAME_ACK
  closes it (``ack``); every other end is a terminal ``empty``,
  ``dropped@<stage>`` or ``expired@<stage>`` mark, so no span stays open.
  ``metrics`` (wired by ``main``) gets the JAX server's series;
* multi-session lanes (``tpu_mesh``): a display of the ``jpeg`` or
  ``x264enc-striped`` profile at its ``device`` rung rides a slot of a lane
  of its (geometry, profile) bucket; a new display is admitted, queued or
  shed by the lanes' live capacity and the load-shedding verdict;
* the stats feed every ``STATS_INTERVAL_S``: ``system_stats``,
  ``network_stats`` (bytes sent, lane counters, the edge block),
  ``system_health`` (with each display's stage breakdown) and
  ``gpu_stats`` (the card's memory).

Capture is X11 (XShm or ``XGetImage``) where an X display is reachable,
else the synthetic desktop. An unknown encoder profile raises.

Concurrency model (same invariant as the JAX server): one asyncio loop
owns all mutable state — the ladder included: errors that the encoder's
threads report through ``on_error`` are queued and counted by the capture
loop; the encoder is driven with non-blocking submits and polls
(``AsyncEncodeDriver``), so the loop never waits on the device.
``websockets`` is imported only in :meth:`DataStreamingServer.run_server`,
so ``ws_handler`` can be driven in process by any object with async
``send``/``close``, async iteration and (optionally) ``send_nowait``.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Set, Tuple

from ..observability.tracing import FlightRecorder
from ..protocol.wire import (
    FrameId,
    ProtocolError,
    pack_full_frame,
    pack_h264_stripe,
    pack_jpeg_stripe,
    pack_system_health,
    parse_text_message,
    unpack_client_binary,
)
from ..robustness import (FAILED, UPLOAD_VERB_COST, BoundedSendQueue,
                          ConnectionGuard, DegradationLadder, EncoderFault,
                          FaultInjector, Supervisor, backoff_delay,
                          classify_verb, parse_limit_spec)
from ..settings import SETTING_DEFINITIONS, Settings
from .backpressure import CHECK_INTERVAL_S, BackpressureState

logger = logging.getLogger("selkies_tpu_torch.server")

STATS_INTERVAL_S = 5.0
UPLOAD_DIR_ENV = "SELKIES_UPLOAD_DIR"

#: largest accepted client display dimension (one frame stays < ~200 MB)
MAX_DISPLAY_DIM = 8192

#: bounded lane geometry-bucket count: each bucket's lanes hold device
#: planes for all their slots. Joins past the cap are served by solo
#: pipelines — the admission verdict and the acquire-time fallback must
#: agree on this number, or verdicts shed clients solo could serve.
MESH_BUCKET_CAP = 4


def _clamp_dim(v: int) -> int:
    """Clamp a client-requested display dimension to [16, MAX] and even."""
    return min(MAX_DISPLAY_DIM, max(16, int(v) & ~1))


def _ws_broadcast(targets, message) -> None:
    """Fan one message out: targets with a synchronous ``send_nowait`` (the
    in-process clients) directly, real websockets via
    ``websockets.broadcast``."""
    real = []
    for t in targets:
        fn = getattr(t, "send_nowait", None)
        if fn is not None:
            try:
                fn(message)
            except Exception:
                logger.debug("send_nowait target failed", exc_info=True)
        else:
            real.append(t)
    if real:
        import websockets

        websockets.broadcast(real, message)


class _TracedChunk:
    """A media chunk carrying its frame's flight-recorder trace through the
    owner's send queue: only the LAST stripe of a frame rides traced (the
    frame is decodable when that stripe lands), so queue/send/ack measure
    the whole frame once."""

    __slots__ = ("payload", "trace", "t_offer")

    def __init__(self, payload, trace, t_offer: float) -> None:
        self.payload = payload
        self.trace = trace
        self.t_offer = t_offer

    def __len__(self) -> int:       # byte accounting as for bytes
        return len(self.payload)


class _ClientSendQueue:
    """Asyncio drainer around a :class:`BoundedSendQueue` for one client.

    The fan-out path offers into the bounded queue (synchronous, never
    blocks the capture loop); this drainer task awaits the transport's
    real ``send``, so per-client flow control backs up into the queue —
    where drop-oldest video and the eviction verdict live — instead of
    into the shared event loop.

    Flight-recorder duty: a :class:`_TracedChunk` passing through closes
    its frame's ``queue`` and ``send`` stages and registers the span for
    ACK correlation; every way a traced chunk can die (drop-oldest
    overflow, a raising send, teardown mid-send) lands a terminal
    ``dropped@`` mark instead of leaking the span."""

    def __init__(self, ws, q: BoundedSendQueue, on_evict,
                 recorder: Optional[FlightRecorder] = None) -> None:
        self.ws = ws
        self.q = q
        self.evicted = False
        self._on_evict = on_evict
        self._recorder = recorder
        # drop-oldest may discard a traced chunk: its span must close
        q.on_drop = self._on_video_dropped
        self._wake = asyncio.Event()
        self.task = asyncio.create_task(self._drain())

    def _on_video_dropped(self, message) -> None:
        if isinstance(message, _TracedChunk) and self._recorder is not None:
            self._recorder.drop(message.trace, "queue")

    def offer(self, message, control: bool) -> None:
        self.q.offer(message, control=control)
        self._wake.set()
        if not self.evicted and self.q.should_evict:
            self.evicted = True
            self._on_evict(self)

    def offer_traced(self, payload, trace) -> None:
        """Queue the frame's last stripe with its trace attached (the queue
        stage opens now; the drainer closes it when it pops the chunk)."""
        self.offer(_TracedChunk(payload, trace, time.monotonic()),
                   control=False)

    async def _send_one(self, message) -> None:
        if not isinstance(message, _TracedChunk):
            await self.ws.send(message)
            return
        tr = message.trace
        now = time.monotonic()
        tr.mark("queue", message.t_offer, now)
        # registered for ACK correlation BEFORE the await: under write
        # backpressure the payload can reach the client, and its ACK the
        # reader task, while this coroutine is still suspended in send
        if self._recorder is not None:
            self._recorder.sent(tr)
        try:
            await self.ws.send(message.payload)
        except BaseException:
            # transport death or cancellation mid-send: terminal mark,
            # then the existing error handling decides the session
            if self._recorder is not None and tr.terminal is None:
                self._recorder.drop(tr, "send")
            raise
        if tr.terminal is None:
            tr.mark("send", now, time.monotonic())

    async def _drain(self) -> None:
        try:
            while True:
                await self._wake.wait()
                self._wake.clear()
                while True:
                    message = self.q.pop()
                    if message is None:
                        break
                    await self._send_one(message)
        except asyncio.CancelledError:
            raise
        except Exception:
            # the connection died mid-send; ws_handler's cleanup owns the
            # socket, the drainer just stops
            logger.debug("send-queue drain ended", exc_info=True)

    def close(self) -> None:
        if not self.task.done():
            self.task.cancel()
        # traced chunks still queued will never be sent
        while True:
            message = self.q.pop()
            if message is None:
                break
            self._on_video_dropped(message)


def upload_dir() -> str:
    """The file-manager root uploads land in: ``SELKIES_UPLOAD_DIR``, else
    ``~/Desktop``."""
    d = os.environ.get(UPLOAD_DIR_ENV) or os.path.join(
        os.path.expanduser("~"), "Desktop")
    os.makedirs(d, exist_ok=True)
    return d


def default_encoder_factory(width: int, height: int, settings: Settings,
                            overrides: Optional[Dict[str, Any]] = None,
                            device=None):
    """The served encoder for one display. ``jpeg`` is the JPEG-stripe
    encoder; ``x264enc-striped`` and ``x264enc`` the H.264 encoder, striped
    or as one full-frame stripe shipped as 0x00 packets (the
    ``wire_fullframe`` flag).

    The ``tpu_entropy`` override picks the rung: the device rung (the
    default; for H.264 ``None`` reads ``SELKIES_TPU_H264_ENTROPY``) is the
    pipelined encoder behind the async driver, the ``host`` rung the
    synchronous encoder behind :class:`ThreadedEncoderAdapter`.

    ``SELKIES_TPU_ASYNC_BATCH`` (default 1) is the number of H.264 frames
    per device dispatch on the device rung. Above 1 a forming batch ships
    when it is full or when its deadline (re-armed by every frame) is due,
    not whenever the driver's queue runs dry. JPEG and the host rungs
    encode one frame at a time whatever it says."""
    from ..encoder.async_driver import AsyncEncodeDriver
    from ..encoder.pipeline import (PipelinedH264Encoder,
                                    PipelinedJpegEncoder,
                                    ThreadedEncoderAdapter)

    ov = overrides or {}
    profile = str(ov.get("encoder", settings.encoder))
    entropy = ov.get("tpu_entropy")
    if profile in ("x264enc", "x264enc-striped"):
        from ..encoder.h264 import H264StripeEncoder

        if str(settings.watermark_path):
            logger.warning("watermark is implemented in the JPEG profile "
                           "only; the H.264 profiles ignore watermark_path")
        fullframe = profile == "x264enc"
        base = H264StripeEncoder(
            width - width % 2, height - height % 2,
            stripe_height=int(settings.tpu_stripe_height),
            qp=int(ov.get("h264_crf", settings.h264_crf.default)),
            paint_over_qp=int(ov.get("h264_paintover_crf",
                                     settings.h264_paintover_crf.default)),
            fullframe=fullframe, entropy=entropy, device=device,
        )
        if base.entropy != "device":
            return ThreadedEncoderAdapter(base, depth=3,
                                          wire_fullframe=fullframe)
        batch = max(1, int(os.environ.get("SELKIES_TPU_ASYNC_BATCH", "1")))
        return AsyncEncodeDriver(
            PipelinedH264Encoder(base, depth=max(4, 3 * batch),
                                 fetch_group=2, batch=batch),
            flush_partial_when_idle=(batch == 1),
            wire_fullframe=fullframe)
    if profile != "jpeg":
        raise ValueError(f"unknown encoder profile {profile!r}")
    from ..encoder.jpeg import JpegStripeEncoder

    base = JpegStripeEncoder(
        width, height,
        stripe_height=int(settings.tpu_stripe_height),
        quality=ov.get("jpeg_quality", settings.jpeg_quality.default),
        paintover_quality=ov.get("paint_over_jpeg_quality",
                                 settings.paint_over_jpeg_quality.default),
        use_paint_over_quality=ov.get("use_paint_over_quality",
                                      settings.use_paint_over_quality.value),
        entropy=entropy or "device",
        watermark_path=str(settings.watermark_path),
        watermark_location=int(settings.watermark_location),
        device=device,
    )
    if base.entropy != "device":
        return ThreadedEncoderAdapter(base, depth=3)
    return AsyncEncodeDriver(PipelinedJpegEncoder(base, depth=4, fetch_group=2))


def rung_overrides(overrides: Dict[str, Any], rung: str) -> Dict[str, Any]:
    """The factory overrides of a degradation-ladder rung: ``host`` codes
    the entropy on the host, ``jpeg`` is the JPEG profile with host
    entropy; ``device`` is the display's own. Every rung runs its kernels
    on the card."""
    ov = dict(overrides)
    if rung == "host":
        ov["tpu_entropy"] = "host"
    elif rung == "jpeg":
        ov["encoder"] = "jpeg"
        ov["tpu_entropy"] = "host"
    return ov


def default_source_factory(width: int, height: int, fps: float,
                           x: int = 0, y: int = 0):
    """X11 capture of the display's region (its layout offset ``x, y``)
    where an X display is reachable, else the synthetic desktop."""
    from ..capture.synthetic import SyntheticSource
    from ..capture.x11 import X11Source

    if X11Source.available():
        return X11Source(width, height, fps, x=x, y=y)
    return SyntheticSource(width, height, fps, pattern="desktop")


def _pack_stripe(frame_id: int, s, encoder) -> bytes:
    """Wire-pack one encoded stripe by profile: JPEG stripes -> 0x03,
    striped H.264 -> 0x04 (the client's per-stripe decoders), full-frame
    H.264 -> 0x00. The full-frame routing is the encoder's
    ``wire_fullframe`` flag: a short display has one stripe in striped mode
    too, and still ships 0x04."""
    if hasattr(s, "annexb"):
        if getattr(encoder, "wire_fullframe", False):
            return pack_full_frame(frame_id, s.annexb, s.is_key)
        return pack_h264_stripe(frame_id, s.y_start, s.width, s.height,
                                s.annexb, s.is_key)
    return pack_jpeg_stripe(frame_id, s.y_start, s.jpeg)


@dataclass
class DisplayState:
    display_id: str
    ws: Any = None
    width: int = 1024
    height: int = 768
    #: framebuffer offset of this display (set by _apply_x11_layout)
    x: int = 0
    y: int = 0
    bp: BackpressureState = field(default_factory=BackpressureState)
    #: serializes start/stop/reconfigure (they await mid-flight, so two
    #: concurrent calls could otherwise both pass the is-running guard and
    #: spawn duplicate capture loops)
    lock: asyncio.Lock = field(default_factory=asyncio.Lock)
    capture_task: Optional[asyncio.Task] = None
    backpressure_task: Optional[asyncio.Task] = None
    #: supervisors owning the two loops above: crash restarts with bounded
    #: backoff, frame-deadline watchdog, restart budget
    supervisor: Optional[Supervisor] = None
    bp_supervisor: Optional[Supervisor] = None
    #: encoder degradation state (device -> host -> jpeg); persists across
    #: supervised restarts — it is display health, not pipeline state
    ladder: DegradationLadder = field(default_factory=DegradationLadder)
    #: sticky terminal marker: the capture supervisor exhausted its restart
    #: budget and the pipeline was torn down (cleared by an explicit
    #: START_VIDEO or SETTINGS restart)
    failed: bool = False
    #: wedge faults at the bottom rung (nowhere left to degrade): each
    #: restart of a hung encoder can abandon a blocked thread, so these are
    #: bounded — a few strikes and the display goes terminal
    wedge_faults: int = 0
    video_active: bool = True
    #: clamped per-client setting overrides from the SETTINGS handshake
    overrides: Dict[str, Any] = field(default_factory=dict)
    #: live encoder of the running capture loop (keyframe kicks, health)
    encoder: Any = None
    #: frames sent since the capture loop (re)started
    frames_sent: int = 0
    #: (w, h, x, y) the running pipeline was started with — scoped
    #: reconfiguration restarts only displays whose geometry changed
    running_geom: Optional[Tuple[int, int, int, int]] = None
    #: (overrides, framerate) snapshot at pipeline start: a SETTINGS
    #: change with unchanged geometry must still rebuild the encoder
    running_config: Optional[Tuple[Dict[str, Any], float]] = None


@dataclass
class _Upload:
    path: str
    rel_path: str  # as the client named it; echoed back in errors
    fobj: Any
    received: int = 0
    size: int = 0


class DataStreamingServer:
    #: bind-retry policy: capped exponential backoff with jitter, then a
    #: hard error — an occupied port fails loudly instead of retrying
    #: forever (class attributes so tests can shrink them)
    BIND_MAX_ATTEMPTS = 8
    BIND_BASE_DELAY_S = 0.5
    BIND_MAX_DELAY_S = 10.0

    def __init__(
        self,
        settings: Settings,
        app=None,
        encoder_factory: Callable = default_encoder_factory,
        source_factory: Callable = default_source_factory,
        input_handler=None,
        host: str = "0.0.0.0",
        device=None,
    ) -> None:
        self.settings = settings
        self.app = app
        self.input_handler = input_handler
        self.encoder_factory = encoder_factory
        self.source_factory = source_factory
        self.host = host
        self.port = settings.port
        #: device the encoders run on (None → the card, raising without one)
        self.device = device
        self.clients: Set[Any] = set()
        self.display_clients: Dict[str, DisplayState] = {}
        self._uploads: Dict[Any, _Upload] = {}
        self._stats_task: Optional[asyncio.Task] = None
        self._stop_event: Optional[asyncio.Event] = None
        self.bytes_sent = 0
        #: observability.Metrics, wired by main() (every call site guarded)
        self.metrics = None
        #: audio.AudioPipeline, wired by main() when audio is enabled
        self.audio_pipeline = None
        #: cleared by STOP_AUDIO until re-requested
        self._audio_wanted = True
        #: frame flight recorder (observability/tracing.py): every served
        #: frame's stage spans, read by the metrics endpoint
        #: (/debug/trace), the system_health feed and the stats loop
        self.recorder = FlightRecorder(capacity=4096)
        #: last xrandr-applied Layout (dedup)
        self._last_layout = None
        #: closed encoders whose threads may still run; pruned at every
        #: capture-loop start, joined by stop()
        self._retired: list = []
        #: fault-injection registry, armed from the tpu_faults setting
        #: (SELKIES_TPU_FAULTS) and checked at the real call sites
        self.faults = FaultInjector(str(settings.tpu_faults or ""))
        #: fire-and-forget helpers (ws.drop closes, failed-display
        #: teardown, slow-client kills), referenced so they are not
        #: collected mid-flight
        self._bg_tasks: Set[asyncio.Task] = set()
        #: multi-session lanes (tpu_mesh): one scheduler per (geometry,
        #: profile) bucket, built at the bucket's first join
        self.mesh_coordinators: Dict[Tuple[int, int, str], Any] = {}
        #: scheduler constructor override (tests): same signature as
        #: MeshEncodeCoordinator — runs the real scheduler over injected
        #: (device-free) lane encoders
        self.coordinator_factory: Optional[Callable] = None
        #: geometries whose scheduler construction failed — scoped per
        #: geometry, so one bad bucket does not disable lanes for the rest
        self._mesh_failed_geoms: Set[Tuple[int, int, str]] = set()
        #: displays served from a lane, and displays the lanes could not
        #: take that were served by a solo encoder instead
        self.mesh_stats = {"bucketed": 0, "solo_fallback": 0}
        #: when each bucket last lost its last session (see
        #: _retire_idle_buckets)
        self._bucket_idle_since: Dict[Tuple[int, int, str], float] = {}
        #: the one thread that ticks every bucket's scheduler (the JAX
        #: server gives each its own; see parallel.coordinator.LaneTicker)
        self._lane_ticker = None
        # --- the wire edge ---
        #: per-class rate limits; a bad rate_limits spec fails construction
        #: loudly, like a bad fault spec
        self._limits = parse_limit_spec(str(settings.rate_limits or ""))
        #: per-connection protocol armor (error budget + class buckets)
        self._guards: Dict[Any, ConnectionGuard] = {}
        #: per-client bounded send queues wrapped around the fan-out path
        self._send_queues: Dict[Any, _ClientSendQueue] = {}
        #: the edge's counters (rate_limited is per message class)
        self.edge_stats: Dict[str, Any] = {
            "protocol_errors": 0,
            "rate_limited": {},
            "upload_paced": 0,
            "sessions_rejected": 0,
            "sessions_queued": 0,
            "slow_client_evictions": 0,
            "reconfigure_runs": 0,
            "reconfigure_coalesced": 0,
        }
        #: debounced, serialized display reconfiguration: a resize storm
        #: coalesces into one reconfigure, not one per message
        self._reconfig_task: Optional[asyncio.Task] = None
        self._reconfig_dirty = False
        #: admission-control load shedding (driven by sustained encoder
        #: drops observed in the stats loop)
        self._load_shedding = False
        self._shed_strikes = 0
        self._last_dropped_total = 0

    # ------------------------------------------------------------------
    # broadcast primitives

    def broadcast(self, message) -> None:
        if self.clients:
            self._fanout(self.clients, message)
            if isinstance(message, (bytes, bytearray)):
                self.bytes_sent += len(message) * len(self.clients)

    def _fanout(self, targets, message) -> None:
        """Fan one message out through the per-client bounded send queues:
        text is control (never dropped), binary media is droppable — a slow
        consumer converges to the live edge of the stream or is evicted,
        and never stalls the capture loop. Targets without a queue (added
        outside ws_handler, or mid-handshake) get the direct transport
        broadcast."""
        control = isinstance(message, str)
        direct = []
        for t in targets:
            cq = self._send_queues.get(t)
            if cq is None:
                direct.append(t)
            elif not cq.evicted:
                cq.offer(message, control)
        if direct:
            _ws_broadcast(direct, message)

    def _evict_slow_client(self, cq: _ClientSendQueue) -> None:
        """Sustained send-queue overflow: this consumer is not keeping up
        and dropping video no longer helps — close its one socket (with a
        best-effort KILL) so its backlog stops costing memory."""
        self.edge_stats["slow_client_evictions"] += 1
        if self.metrics is not None:
            self.metrics.inc_slow_client_eviction()
        logger.warning(
            "evicting slow consumer: queue depth %d, %d video drops",
            len(cq.q), cq.q.dropped_video_total)
        cq.close()   # the drainer may be wedged inside a stalled send
        ws = cq.ws

        async def _kill():
            try:
                await asyncio.wait_for(ws.send("KILL slow_consumer"), 1.0)
            except Exception:
                pass
            await ws.close()

        self._spawn_background(_kill(), "evict-slow-client")

    def _viewers_of(self, display_id: str) -> Set[Any]:
        """Primary-display media goes to every client; secondary displays
        only to their owner."""
        if display_id == "primary":
            return set(self.clients)
        st = self.display_clients.get(display_id)
        return {st.ws} if st and st.ws else set()

    def _display_of(self, websocket) -> Optional[DisplayState]:
        for st in self.display_clients.values():
            if st.ws is websocket:
                return st
        # viewers (shared mode) ride the primary display
        return self.display_clients.get("primary")

    def _display_id_of(self, websocket) -> str:
        st = self._display_of(websocket)
        return st.display_id if st else "primary"

    # ------------------------------------------------------------------
    # lifecycle

    async def run_server(self) -> None:
        """Serve until :meth:`stop`. A failed bind is retried with capped
        exponential backoff and raised after ``BIND_MAX_ATTEMPTS``. No
        capture or encoder error ends it: the display's supervisor
        restarts, degrades or fails that display alone."""
        import websockets.asyncio.server as ws_server

        self._stop_event = asyncio.Event()
        bind_attempts = 0
        # transport-level armor: an unbounded max_size lets one client
        # frame buffer arbitrary memory before any handler runs
        cap_mb = int(getattr(self.settings, "max_ws_message_mb", 0))
        max_size = cap_mb * 1024 * 1024 if cap_mb > 0 else None
        while not self._stop_event.is_set():
            try:
                async with ws_server.serve(self.ws_handler, self.host,
                                           self.port, compression=None,
                                           max_size=max_size):
                    bind_attempts = 0
                    logger.info("data server listening on %s:%d",
                                self.host, self.port)
                    await self._stop_event.wait()
            except OSError as e:
                bind_attempts += 1
                if bind_attempts >= self.BIND_MAX_ATTEMPTS:
                    raise RuntimeError(
                        f"data server could not bind {self.host}:{self.port}"
                        f" after {bind_attempts} attempts: {e}") from e
                delay = backoff_delay(bind_attempts, self.BIND_BASE_DELAY_S,
                                      self.BIND_MAX_DELAY_S, jitter=0.25)
                logger.error("server bind failed (%s); retry %d/%d in %.1fs",
                             e, bind_attempts, self.BIND_MAX_ATTEMPTS, delay)
                await asyncio.sleep(delay)

    async def stop(self) -> None:
        task = self._reconfig_task
        if task is not None and not task.done():
            task.cancel()
            try:
                await task
            except asyncio.CancelledError:
                pass
        for cq in list(self._send_queues.values()):
            cq.close()
        self._send_queues.clear()
        for st in list(self.display_clients.values()):
            await self._stop_display(st)
        # closed encoders' threads finish their last device call off the
        # loop; shutdown waits for them (bounded)
        retired, self._retired = self._retired, []
        for enc in retired:
            await asyncio.to_thread(enc.join, 10.0)
        for coord in self.mesh_coordinators.values():
            coord.stop()
        self.mesh_coordinators.clear()
        if self.audio_pipeline is not None:
            await self.audio_pipeline.stop()
            self.audio_pipeline.close()
        if self._stats_task:
            self._stats_task.cancel()
        if self._stop_event:
            self._stop_event.set()

    # ------------------------------------------------------------------
    # connection handling

    async def _admit(self, websocket) -> bool:
        """Admission control at accept time: a full or load-shedding
        server rejects the connection gracefully — a wire KILL the client
        UI can show — instead of degrading every session."""
        maxc = int(self.settings.max_clients or 0)
        full = bool(maxc and len(self.clients) >= maxc)
        if not full and not self._load_shedding:
            return True
        self.edge_stats["sessions_rejected"] += 1
        if self.metrics is not None:
            self.metrics.inc_sessions_rejected()
        logger.warning("connection rejected: %s",
                       "server_full" if full else "load_shedding")
        try:
            await websocket.send("KILL server_full")
        except Exception:
            pass
        try:
            await websocket.close()
        except Exception:
            pass
        return False

    # -- display-plane admission: scheduler verdicts --

    def _mesh_profile_of(self, overrides: Dict[str, Any]) -> str:
        return str(overrides.get("encoder", self.settings.encoder))

    def _display_admission_verdict(self, width: int, height: int,
                                   overrides: Dict[str, Any]) -> str:
        """``admit`` / ``queue`` / ``shed`` for a NEW display join.

        A load-shedding server sheds; the flat ``max_displays`` cap is the
        hard backstop; below it the verdict comes from live lane capacity:
        a join whose geometry bucket has a free or growable slot is
        admitted, a join into a momentarily full scheduler queues (leave
        and resize churn frees slots within the queue window), and a full
        scheduler sheds. Displays the lanes cannot serve (other profiles,
        watermark, failed geometries) are admitted toward their solo
        pipelines, and ``mesh_overflow_solo`` sends overflow to solo
        pipelines wholesale."""
        if self._load_shedding:
            return "shed"
        maxd = int(self.settings.max_displays or 0)
        if maxd and len(self.display_clients) >= maxd:
            return "shed"
        if not str(self.settings.tpu_mesh) or \
                bool(self.settings.mesh_overflow_solo.value):
            return "admit"
        profile = self._mesh_profile_of(overrides)
        if profile not in ("jpeg", "x264enc-striped") or \
                str(self.settings.watermark_path):
            return "admit"          # solo-served by design, not overflow
        geom = (_clamp_dim(width), _clamp_dim(height), profile)
        coord = self.mesh_coordinators.get(geom)
        if coord is None:
            # a fresh bucket can be built, or past the bucket cap the
            # acquire path serves the join solo: admit toward either,
            # never queue on a condition that cannot resolve
            return "admit"
        try:
            cap = coord.capacity()
        except Exception:
            return "admit"
        if cap["slots_free"] + cap["growable_slots"] > 0:
            return "admit"
        return "queue"

    async def _await_display_admission(self, width: int, height: int,
                                       overrides: Dict[str, Any]) -> str:
        """Hold a queued join for up to ``admission_queue_ms`` waiting for
        a lane slot to free, then resolve to admit or shed. Bounded by
        construction: a queued client is never parked forever."""
        self.edge_stats["sessions_queued"] += 1
        if self.metrics is not None:
            self.metrics.inc_sessions_queued()
        wait_ms = int(self.settings.admission_queue_ms or 0)
        deadline = time.monotonic() + wait_ms / 1000.0
        while True:
            verdict = self._display_admission_verdict(
                width, height, overrides)
            if verdict != "queue":
                return verdict
            if time.monotonic() >= deadline:
                return "shed"
            await asyncio.sleep(0.025)

    def scheduler_stats(self) -> Optional[Dict[str, int]]:
        """Aggregate live lane capacity across geometry buckets (None when
        lanes are off) — the admission verdicts' input."""
        if not str(self.settings.tpu_mesh):
            return None
        agg = {"slots_free": 0, "growable_slots": 0, "slots_total": 0,
               "quarantined_slots": 0, "active_sessions": 0, "lanes": 0}
        for coord in self.mesh_coordinators.values():
            try:
                cap = coord.capacity()
            except Exception:
                continue
            for k in agg:
                agg[k] += int(cap.get(k, 0))
        return agg

    async def ws_handler(self, websocket) -> None:
        if not await self._admit(websocket):
            return
        self._guards[websocket] = ConnectionGuard(
            limits=self._limits,
            error_budget=int(self.settings.protocol_error_budget))
        self.clients.add(websocket)
        if self.metrics is not None:
            self.metrics.set_clients(len(self.clients))
        primary = self.display_clients.get("primary")
        if primary is not None and primary.encoder is not None:
            # late-joining viewer: damage gating would never send it the
            # static content, so the next frame refreshes every stripe
            primary.encoder.force_keyframe()
        try:
            if (self.audio_pipeline is not None and self._audio_wanted
                    and not self.audio_pipeline.running):
                await self.audio_pipeline.start()
            await websocket.send("MODE websockets")
            if self.app and self.app.last_cursor_sent:
                await websocket.send(
                    "cursor," + json.dumps(self.app.last_cursor_sent))
            await websocket.send(json.dumps(self.settings.schema_payload()))
            # handshake done: fan-out to this client now rides its bounded
            # send queue (slow-consumer isolation + eviction)
            self._send_queues[websocket] = _ClientSendQueue(
                websocket,
                BoundedSendQueue(
                    max_video=int(self.settings.max_send_queue),
                    evict_after_s=float(int(
                        self.settings.slow_client_evict_s))),
                on_evict=self._evict_slow_client,
                recorder=self.recorder)
            if self._stats_task is None or self._stats_task.done():
                self._stats_task = asyncio.create_task(self._stats_loop())
            async for message in websocket:
                # per-message exception boundary: a malformed or
                # handler-crashing message is dropped and charged against
                # this connection's error budget — it never ends the
                # session the way a transport error does
                try:
                    if isinstance(message, (bytes, bytearray)):
                        await self._handle_binary(websocket, message)
                    else:
                        await self._handle_text(websocket, message)
                except Exception as e:
                    if (isinstance(e, ConnectionError)
                            or type(e).__name__.startswith(
                                "ConnectionClosed")):
                        # a handler failing to send to a dead peer is
                        # transport death, not client hostility: end the
                        # session instead of charging the budget
                        raise
                    self.edge_stats["protocol_errors"] += 1
                    if self.metrics is not None:
                        self.metrics.inc_protocol_errors()
                    logger.debug("protocol error (dropped message): %r", e)
                    guard = self._guards.get(websocket)
                    if guard is not None and guard.record_error():
                        logger.warning(
                            "error budget exhausted after %d protocol "
                            "errors; killing abusive client",
                            guard.errors_total)
                        try:
                            await websocket.send("KILL protocol_abuse")
                        except Exception:
                            pass
                        await websocket.close()
                        break
        except Exception as e:  # connection errors end the session
            logger.debug("ws session ended: %r", e)
        finally:
            self.clients.discard(websocket)
            self._guards.pop(websocket, None)
            cq = self._send_queues.pop(websocket, None)
            if cq is not None:
                cq.close()
            if self.metrics is not None:
                self.metrics.set_clients(len(self.clients))
            up = self._uploads.pop(websocket, None)
            if up is not None:
                # never leak the fd or the partial file of an interrupted
                # upload
                self._abort_upload(up)
                logger.info("upload aborted by disconnect: %s (%d/%d bytes)",
                            up.path, up.received, up.size)
            dropped = False
            for st in list(self.display_clients.values()):
                if st.ws is websocket:
                    # deregister first: a concurrent reconfigure worker
                    # must see the display as gone before our stop lands,
                    # or it can restart a zombie pipeline holding its
                    # scheduler slot
                    del self.display_clients[st.display_id]
                    await self._stop_display(st)
                    dropped = True
            if dropped and self.display_clients:
                # surviving displays reflow into a smaller framebuffer
                self._schedule_reconfigure()
            if (not self.clients and self.audio_pipeline is not None
                    and self.audio_pipeline.running):
                await self.audio_pipeline.stop()

    # ------------------------------------------------------------------
    # text protocol

    def _count_rate_limited(self, cls: str) -> None:
        counts = self.edge_stats["rate_limited"]
        counts[cls] = counts.get(cls, 0) + 1
        if self.metrics is not None:
            self.metrics.inc_rate_limited(cls)

    def _count_upload_paced(self) -> None:
        # pacing accepts the message after a sleep: a separate counter so
        # a fast healthy upload never reads as "dropped by rate limiting"
        self.edge_stats["upload_paced"] += 1
        if self.metrics is not None:
            self.metrics.inc_upload_paced()

    async def _handle_text(self, websocket, message: str) -> None:
        msg = parse_text_message(message)   # ProtocolError → boundary
        verb = msg.verb

        guard = self._guards.get(websocket)
        if guard is not None:
            cls = classify_verb(verb)
            if cls == "upload":
                # stateful upload verbs are paced like upload bytes, never
                # dropped — a dropped FILE_UPLOAD_END leaves the fd open
                # and splices the next file into it
                wait = guard.throttle("upload", UPLOAD_VERB_COST)
                if wait > 0:
                    self._count_upload_paced()
                    await asyncio.sleep(wait)
            elif not guard.allow(cls):
                self._count_rate_limited(cls)
                logger.debug("rate-limited %s message %r", cls, verb[:32])
                return

        if verb == "SETTINGS":
            await self._on_settings(websocket, msg.json_body or "{}")
        elif verb == "CLIENT_FRAME_ACK":
            # only the display's owner acks: a viewer (or a hostile
            # client) feeding ids into the primary's backpressure state
            # would wedge the gate for everyone
            st = self._display_of(websocket)
            if st and st.ws is websocket and msg.args:
                try:
                    fid = int(msg.args[0])
                except ValueError:
                    pass
                else:
                    st.bp.on_client_ack(fid)
                    # the ACK closes the frame's span with the true
                    # network round trip (send end -> ack arrival)
                    self.recorder.ack(st.display_id, fid)
        elif verb == "r" and len(msg.args) >= 1:
            await self._on_resize(websocket, msg.args)
        elif verb == "START_VIDEO":
            st = self._display_of(websocket)
            if st and st.ws is websocket:
                st.video_active = True
                await self._start_display(st)
                # through the send queue: the reply must not overtake media
                # already queued ahead of it
                self._fanout({websocket}, "VIDEO_STARTED")
        elif verb == "STOP_VIDEO":
            st = self._display_of(websocket)
            if st and st.ws is websocket:
                st.video_active = False
                await self._stop_display(st)
                self._fanout({websocket}, "VIDEO_STOPPED")
        elif verb == "START_AUDIO":
            self._audio_wanted = True
            if self.audio_pipeline is not None:
                await self.audio_pipeline.start()
                self.broadcast("AUDIO_STARTED")
        elif verb == "STOP_AUDIO":
            self._audio_wanted = False
            if self.audio_pipeline is not None:
                await self.audio_pipeline.stop()
                self.broadcast("AUDIO_STOPPED")
        elif verb == "FILE_UPLOAD_START":
            await self._on_upload_start(websocket, msg.args)
        elif verb == "FILE_UPLOAD_END":
            up = self._uploads.pop(websocket, None)
            if up:
                up.fobj.close()
                if up.size and up.received < up.size:
                    # a short upload is a broken file: remove it and tell
                    # the client rather than leaving truncated data behind
                    logger.warning("short upload removed: %s (%d/%d bytes)",
                                   up.path, up.received, up.size)
                    try:
                        os.unlink(up.path)
                    except OSError:
                        pass
                    await websocket.send(
                        f"FILE_UPLOAD_ERROR:{up.rel_path}:"
                        f"short upload ({up.received}/{up.size} bytes)")
                else:
                    logger.info("upload finished: %s (%d bytes)",
                                up.path, up.received)
        elif verb == "FILE_UPLOAD_ERROR":
            up = self._uploads.pop(websocket, None)
            if up:
                self._abort_upload(up)
        elif verb == "s" and msg.args:
            # scale request ("s,<scale>"): HiDPI factor → Xft DPI
            try:
                scale = min(4.0, max(0.5, float(msg.args[0])))
                await self._apply_dpi(int(round(96 * scale)))
            except ValueError:
                pass
        elif verb == "SET_NATIVE_CURSOR_RENDERING" and msg.args:
            # the client renders the cursor itself: re-send the last one
            # so the toggle takes effect at once
            if self.app is not None and self.app.last_cursor_sent:
                try:
                    await websocket.send(
                        "cursor," + json.dumps(self.app.last_cursor_sent))
                except Exception:
                    pass
        elif verb == "cmd":
            if self.settings.command_enabled.value and msg.args:
                await self._run_command(msg.args[0])
        else:
            # everything else is input-plane grammar, forwarded whole
            if verb == "_f":
                st = self._display_of(websocket)
                if st and st.ws is websocket and msg.args:
                    try:
                        fps = float(msg.args[0])
                        st.bp.on_client_fps(fps)
                        if self.metrics is not None:
                            self.metrics.set_fps(fps)
                    except ValueError:
                        pass
            elif verb == "_l" and msg.args and self.metrics is not None:
                try:
                    self.metrics.set_latency(float(msg.args[0]))
                except ValueError:
                    pass
            if self.input_handler is not None:
                await self.input_handler.on_message(
                    message, self._display_id_of(websocket))
            else:
                logger.debug("unhandled message verb %r", verb)

    # ------------------------------------------------------------------
    # binary protocol (client → server)

    async def _handle_binary(self, websocket, data: bytes) -> None:
        if not data:
            raise ProtocolError("empty binary frame")
        guard = self._guards.get(websocket)
        t = data[0]
        if t == 0x01:  # file chunk
            if guard is not None:
                # uploads are paced, not dropped (a dropped chunk corrupts
                # the file): sleeping here stops reading the socket, which
                # backpressures the sender through TCP. Charged before the
                # open-upload check, so orphan 0x01 floods are metered too
                wait = guard.throttle("upload", len(data))
                if wait > 0:
                    self._count_upload_paced()
                    await asyncio.sleep(wait)
            up = self._uploads.get(websocket)
            if up:
                # the absolute cap holds even when the client declares
                # size 0 (or lies): the declared size is a courtesy check
                cap = self.settings.max_upload_mb * 1024 * 1024
                limit = min(up.size, cap) if up.size else cap
                if limit and up.received + len(data) - 1 > limit:
                    self._uploads.pop(websocket, None)
                    self._abort_upload(up)
                    await websocket.send(
                        f"FILE_UPLOAD_ERROR:{up.rel_path}:"
                        "exceeded size limit")
                    return
                up.fobj.write(data[1:])
                up.received += len(data) - 1
        elif t == 0x02:  # microphone PCM
            cap = int(self.settings.max_mic_chunk_kb) * 1024
            if cap and len(data) - 1 > cap:
                raise ProtocolError(
                    f"mic chunk of {len(data) - 1} bytes exceeds "
                    f"{cap}-byte cap")
            if guard is not None and not guard.allow("mic", len(data)):
                self._count_rate_limited("mic")
                return
            if self.audio_pipeline is not None:
                await self.audio_pipeline.on_mic_data(data[1:])
        else:
            # the canonical demux raises the precise rejection (wrong
            # direction 0x00/0x03/0x04 vs unknown)
            unpack_client_binary(data)
            raise ProtocolError(f"unroutable client binary type 0x{t:02x}")

    def _abort_upload(self, up: _Upload) -> None:
        """Close the fd and remove the partial file of a dead upload."""
        try:
            up.fobj.close()
        except Exception:
            pass
        try:
            os.unlink(up.path)
        except OSError:
            pass

    # ------------------------------------------------------------------
    # settings negotiation

    async def _on_settings(self, websocket, body: str) -> None:
        try:
            requested = json.loads(body)
        except json.JSONDecodeError:
            logger.warning("bad SETTINGS payload")
            return
        display_id = str(requested.get("displayId", "primary"))
        if display_id != "primary" and not self.settings.second_screen.value:
            await websocket.send("KILL Second screens are disabled on this server.")
            await websocket.close()
            return
        # parse/clamp every value before touching state: garbage costs only
        # itself, never a half-registered zombie display
        known = {s.name for s in SETTING_DEFINITIONS}
        applied: Dict[str, Any] = {}
        width = height = None
        for key, value in requested.items():
            if key == "displayId":
                continue
            try:
                if key == "initialClientWidth":
                    width = _clamp_dim(value)
                elif key == "initialClientHeight":
                    height = _clamp_dim(value)
                elif key in known:
                    applied[key] = self.settings.clamp_client_value(key, value)
            except (TypeError, ValueError):
                logger.warning("ignoring bad client setting %s=%r", key, value)

        st = self.display_clients.get(display_id)
        if st and st.ws is not None and st.ws is not websocket:
            # superseded client for this display: kill the old one
            try:
                await st.ws.send("KILL Display taken over by another client.")
                await st.ws.close()
            except Exception:
                pass
        if st is None:
            # admission control on the display plane: each display is a
            # capture+encode pipeline, far heavier than a viewer — the
            # verdict comes from load shedding and live lane capacity
            # (admit / queue / shed), with max_displays as the hard
            # backstop
            verdict = self._display_admission_verdict(
                width or 1024, height or 768, applied)
            if verdict == "queue":
                verdict = await self._await_display_admission(
                    width or 1024, height or 768, applied)
            if verdict != "admit":
                self.edge_stats["sessions_rejected"] += 1
                if self.metrics is not None:
                    self.metrics.inc_sessions_rejected()
                logger.warning("display %s rejected (%s): %d displays live",
                               display_id, verdict, len(self.display_clients))
                await websocket.send("KILL server_full")
                await websocket.close()
                return
            # the queue wait yields the loop: another handshake may have
            # registered this display meanwhile — adopt it (superseding
            # its client), don't clobber it
            st = self.display_clients.get(display_id)
            if st is not None and st.ws is not None \
                    and st.ws is not websocket:
                try:
                    await st.ws.send(
                        "KILL Display taken over by another client.")
                    await st.ws.close()
                except Exception:
                    pass
            if st is None:
                st = DisplayState(display_id=display_id)
                self.display_clients[display_id] = st
        st.ws = websocket
        if width is not None:
            st.width = width
        if height is not None:
            st.height = height
        st.overrides.update(applied)
        if "framerate" in applied:
            st.bp.framerate = float(applied["framerate"])
        logger.info("client settings for %s: %s", display_id, applied)

        if "scaling_dpi" in applied:
            await self._apply_dpi(int(applied["scaling_dpi"]))
        self._schedule_reconfigure()

    async def _apply_dpi(self, dpi: int) -> None:
        from ..display import DpiManager

        try:
            await asyncio.to_thread(DpiManager().set_dpi, dpi)
        except ValueError as e:
            logger.warning("dpi rejected: %s", e)

    async def _on_resize(self, websocket, args) -> None:
        if self.settings.is_manual_resolution_mode.value:
            return
        try:
            res = args[0]
            display_id = args[1] if len(args) > 1 else "primary"
            w, h = (int(v) for v in res.split("x"))
        except (ValueError, IndexError):
            return
        st = self.display_clients.get(display_id)
        if not st or st.ws is not websocket:
            # resizing is owner-only: a viewer must not force
            # reconfigurations of someone else's display
            return
        st.width, st.height = _clamp_dim(w), _clamp_dim(h)
        self._schedule_reconfigure()
        self.broadcast(json.dumps({
            "type": "stream_resolution",
            "width": st.width,
            "height": st.height,
        }))

    def _schedule_reconfigure(self) -> None:
        """Debounce and coalesce display reconfiguration behind one
        serialized worker task: a client spamming ``r,<WxH>`` costs one
        reconfiguration per storm, not one per message."""
        self._reconfig_dirty = True
        if self._reconfig_task is None or self._reconfig_task.done():
            self._reconfig_task = asyncio.create_task(
                self._reconfigure_worker())
        else:
            self.edge_stats["reconfigure_coalesced"] += 1
            if self.metrics is not None:
                self.metrics.inc_reconfigure_coalesced()

    async def _reconfigure_worker(self) -> None:
        try:
            debounce = max(0, int(self.settings.resize_debounce_ms)) / 1000.0
            while self._reconfig_dirty:
                if debounce:
                    # absorb the rest of the storm before doing the work;
                    # requests landing mid-run re-arm the dirty flag and
                    # get one more (batched) pass
                    await asyncio.sleep(debounce)
                self._reconfig_dirty = False
                self.edge_stats["reconfigure_runs"] += 1
                await self._reconfigure_displays()
        except asyncio.CancelledError:
            raise
        except Exception:
            # a failed reconfigure must not take the worker down with an
            # unretrieved exception; the next request starts a fresh one
            logger.exception("display reconfiguration failed")

    async def _reconfigure_displays(self) -> None:
        """Stop captures, re-arrange the X screen, then restart active
        pipelines with their new geometry and offsets.

        With a real X server (xrandr) every capture stops first, so no
        capture races a shrinking root window. Without one (synthetic
        capture) the restart is scoped to displays whose geometry or
        settings changed: under join/leave/resize churn a stop-the-world
        restart per event would itself be the outage."""
        from ..display import xrandr_available

        scoped = not xrandr_available()
        if not scoped:
            for st in list(self.display_clients.values()):
                await self._stop_display(st)
        await self._apply_x11_layout()
        for st in list(self.display_clients.values()):
            if not (st.video_active and st.ws is not None):
                continue
            # running_geom/_config are what the live pipeline was started
            # with; st.width/height/overrides carry the request. An
            # offset-only shift (every join reflows the layout) does not
            # restart in scoped mode; a settings change does — the
            # encoder is built from that snapshot
            changed = (st.running_geom is None
                       or st.running_geom[:2] != (st.width, st.height)
                       or st.running_config != (st.overrides,
                                                st.bp.framerate))
            running = st.capture_task is not None \
                and not st.capture_task.done()
            if scoped and running and not changed:
                continue        # untouched display keeps streaming
            if scoped and running:
                await self._stop_display(st)
            await self._start_display(st)

    async def _apply_x11_layout(self) -> None:
        """Arrange the client displays into one framebuffer and mirror it
        onto the X screen (xrandr modes, --fb, --setmonitor). Always
        updates the per-display offsets; the xrandr half is skipped on
        hosts without it or when the layout is unchanged since the last
        apply."""
        from ..display import XrandrManager, compute_layout, xrandr_available

        if not self.display_clients:
            return
        displays = {d: (st.width, st.height)
                    for d, st in self.display_clients.items()}
        primary = self.display_clients.get("primary")
        position = ((primary.overrides.get("second_screen_position")
                     if primary else None)
                    or self.settings.second_screen_position)
        try:
            layout = compute_layout(displays, position)
        except ValueError as e:
            logger.warning("layout rejected: %s", e)
            return
        for p in layout.placements:
            stp = self.display_clients.get(p.display_id)
            if stp:
                stp.x, stp.y = p.x, p.y
        if not xrandr_available() or layout == self._last_layout:
            return
        try:
            mgr = XrandrManager()
            if len(layout.placements) == 1:
                p = layout.placements[0]
                await asyncio.to_thread(mgr.resize, p.width, p.height)
            else:
                await asyncio.to_thread(mgr.apply_layout, layout)
            self._last_layout = layout
        except Exception as e:
            logger.warning("x11 layout apply failed: %s", e)

    # ------------------------------------------------------------------
    # capture / encode pipeline per display

    async def reconfigure_display(self, st: DisplayState) -> None:
        async with st.lock:
            await self._stop_display_locked(st)
            if st.video_active:
                await self._start_display_locked(st)

    async def _start_display(self, st: DisplayState) -> None:
        async with st.lock:
            await self._start_display_locked(st)

    async def _stop_display(self, st: DisplayState) -> None:
        async with st.lock:
            await self._stop_display_locked(st)

    async def _start_display_locked(self, st: DisplayState) -> None:
        if self.display_clients.get(st.display_id) is not st:
            return          # deregistered while this start was pending
        if st.capture_task and not st.capture_task.done():
            return
        # a failed supervisor may leave a live backpressure task behind;
        # tear both down so restarts never leak a ticking loop
        await self._stop_display_locked(st)
        st.failed = False          # an explicit restart clears the marker
        st.wedge_faults = 0
        s = self.settings
        st.ladder.fail_threshold = max(1, int(s.ladder_fail_threshold))
        st.ladder.probe_after_s = int(s.ladder_probe_ms) / 1000.0
        fps = st.bp.framerate or 60.0
        wd_frames = int(s.watchdog_frames)
        watchdog_s = (max(0.5, wd_frames / max(1.0, fps))
                      if wd_frames > 0 else None)
        max_restarts = int(s.supervisor_max_restarts)
        window_s = float(int(s.supervisor_restart_window_s))

        def on_event(kind: str, info: Any) -> None:
            self._on_supervisor_event(st, kind, info)

        st.supervisor = Supervisor(
            f"capture:{st.display_id}", lambda: self._capture_loop(st),
            max_restarts=max_restarts, restart_window_s=window_s,
            watchdog_timeout_s=watchdog_s, on_event=on_event)
        st.bp_supervisor = Supervisor(
            f"backpressure:{st.display_id}",
            lambda: self._backpressure_loop(st),
            max_restarts=max_restarts, restart_window_s=window_s,
            on_event=on_event)
        st.capture_task = asyncio.create_task(st.supervisor.run())
        st.backpressure_task = asyncio.create_task(st.bp_supervisor.run())
        st.running_geom = (st.width, st.height, st.x, st.y)
        st.running_config = (dict(st.overrides), st.bp.framerate)

    async def _stop_display_locked(self, st: DisplayState) -> None:
        """Exception-safe teardown: cancel both tasks even if the first
        cancellation raises, and always close the encoder."""
        for attr in ("capture_task", "backpressure_task"):
            task = getattr(st, attr)
            if task and not task.done():
                task.cancel()
                try:
                    await task
                except asyncio.CancelledError:
                    pass
                except Exception:
                    logger.exception("%s teardown for %s raised",
                                     attr, st.display_id)
            setattr(st, attr, None)
        st.supervisor = None
        st.bp_supervisor = None
        st.running_geom = None
        st.running_config = None
        # a stopped display's un-ACKed frames will never resolve
        self.recorder.drop_awaiting(st.display_id, "stop")
        encoder, st.encoder = st.encoder, None
        if encoder is not None:
            self._retire(encoder)

    def _retire(self, encoder) -> None:
        """Close an encoder without blocking the loop (its thread finishes
        the frame in hand and exits); keep it for stop() to join."""
        try:
            encoder.close()
        except Exception:
            logger.exception("encoder close raised")
        if hasattr(encoder, "join"):
            self._retired.append(encoder)

    async def _reset_frame_ids_and_notify(self, st: DisplayState) -> None:
        st.bp.reset()
        # ids restart at 1: frames sent under the old numbering will never
        # be ACKed, so their spans close here
        self.recorder.drop_awaiting(st.display_id, "reset")
        message = f"PIPELINE_RESETTING {st.display_id}"
        if st.display_id == "primary":
            self.broadcast(message)
        elif st.ws:
            # the same per-client queue as the media: the reset keeps its
            # FIFO place behind the frames already queued
            self._fanout({st.ws}, message)

    async def _capture_loop(self, st: DisplayState) -> None:
        """Source frames → pipelined encode → 0x03/0x04/0x00 fan-out: one
        supervised run (``st.supervisor`` owns the restarts).

        Exceptions propagate to the supervisor; encoder-path failures are
        wrapped in :class:`EncoderFault`, so they step the degradation
        ladder. The loop returns cleanly when the rung changed under it;
        the supervisor then restarts it, which builds the new rung's
        encoder (:func:`rung_overrides`). Frame ids restart
        at 1 on every (re)start, announced with ``PIPELINE_RESETTING`` so
        the client and the backpressure gate drop the old horizon; a new
        encoder's first frame is a keyframe."""
        sup = st.supervisor
        faults = self.faults
        fps = st.bp.framerate or 60.0
        rung = st.ladder.rung
        await self._reset_frame_ids_and_notify(st)
        st.frames_sent = 0
        # keep only the retired encoders whose threads still run
        self._retired = [e for e in self._retired if not e.join(0)]
        # at the device rung a lane slot, when lanes serve this display;
        # a lower rung (or no slot) builds the display's own encoder
        encoder = self._acquire_mesh_encoder(st, fps) \
            if rung == "device" else None
        if encoder is None:
            try:
                encoder = self.encoder_factory(
                    st.width, st.height, self.settings,
                    rung_overrides(st.overrides, rung), device=self.device)
            except Exception as e:
                # a rung that cannot be built steps the ladder like any
                # other encoder failure, instead of being retried forever
                raise EncoderFault(
                    f"encoder construction failed: {e!r}") from e
        #: frames the encoder's threads lost (on_error runs in the driver
        #: thread, or in poll for the threaded adapter); this loop counts
        #: them on the ladder, which only the event loop touches. A lane
        #: facade has no on_error: the scheduler charges its slot instead
        errors: deque = deque()
        if hasattr(encoder, "on_error"):
            encoder.on_error = errors.append
        if getattr(encoder, "faults", False) is None:
            # the async driver checks fetch.hang at its own harvest site
            encoder.faults = faults
        if getattr(encoder, "metrics", False) is None:
            encoder.metrics = self.metrics
        st.encoder = encoder
        source = None
        recorder = self.recorder
        #: flight-recorder spans of frames submitted but not yet harvested,
        #: by the seq try_submit returned (every encoder here returns one
        #: for an accepted frame); results come in submission order
        pending_tr: Dict[int, Any] = {}
        try:
            sup.beat()   # encoder construction counts as progress
            try:
                source = self.source_factory(st.width, st.height, fps,
                                             x=st.x, y=st.y)
            except TypeError:   # a factory without offsets (tests)
                source = self.source_factory(st.width, st.height, fps)
            source.start()
            frame_id = 0
            interval = 1.0 / fps
            next_tick = time.monotonic()
            #: ticks whose harvest surfaced encoder errors without the
            #: ladder stepping (i.e. at the bottom rung): after the
            #: ladder's own threshold, force a supervised rebuild rather
            #: than streaming nothing forever
            error_ticks = 0
            #: a pipeline that stops accepting submits and harvesting
            #: anything is wedged even though the loop itself still ticks;
            #: a generous deadline, so that a first-use kernel build never
            #: reads as a wedge
            wedge_s = None
            if sup.watchdog_timeout_s is not None:
                wedge_s = max(4.0 * sup.watchdog_timeout_s, 30.0)
            accepted_at = time.monotonic()
            logger.info("capture loop started for %s (%dx%d@%g, rung=%s)",
                        st.display_id, st.width, st.height, fps, rung)
            consume_migration = getattr(encoder, "consume_migration", None)
            pop_trace = getattr(encoder, "pop_trace", None)
            while True:
                sup.beat()
                faults.maybe_raise("capture.raise")
                await faults.maybe_hang("capture.stall")
                if consume_migration is not None and consume_migration():
                    # the scheduler live-migrated this session off a
                    # quarantined slot: same recovery grammar as a
                    # supervised restart — frame ids restart with
                    # PIPELINE_RESETTING, the new slot's reset forces a
                    # keyframe, and the restart budget is forgiven (the
                    # scheduler absorbed the fault; the session is healthy)
                    logger.warning("display %s migrated to a healthy "
                                   "lane slot; resetting frame ids",
                                   st.display_id)
                    frame_id = 0
                    await self._reset_frame_ids_and_notify(st)
                    sup.forgive()
                    self._broadcast_health()
                # clean-probe evidence for the ladder: the tick exercised
                # the encoder (submit or delivery) and surfaced no error
                failures_before = st.ladder.failures_total
                progressed = False
                accepted = True     # "no submit attempted" is not a wedge
                if st.bp.send_enabled:
                    t_cap0 = time.monotonic()
                    frame = source.next_frame()
                    t_cap1 = time.monotonic()
                    if frame is not None:
                        # open this frame's span: (display, frame) context
                        # threaded capture -> ... -> client ACK
                        tr = recorder.begin(st.display_id, t=t_cap0)
                        tr.mark("capture", t_cap0, t_cap1)
                        try:
                            faults.maybe_raise("encode.raise")
                            # None = dropped (pipeline full)
                            seq = encoder.try_submit(frame)
                        except Exception as e:
                            recorder.drop(tr, "submit")
                            raise EncoderFault(
                                f"encoder submit failed: {e!r}") from e
                        accepted = seq is not None
                        if not accepted:
                            # backpressure at the edge: a dropped frame
                            # closes terminally, it never leaks a span
                            recorder.drop(tr, "submit")
                        else:
                            # a reused seq (a lane facade numbers at
                            # harvest): the superseded frame's span closes
                            old = pending_tr.get(seq)
                            if old is not None:
                                recorder.drop(old, "submit")
                            pending_tr[seq] = tr
                            # a pipeline accepting submits but never
                            # harvesting must not grow this map
                            while len(pending_tr) > 512:
                                recorder.drop(pending_tr.pop(
                                    next(iter(pending_tr))), "submit")
                        progressed = True
                await faults.maybe_hang("fetch.hang")
                try:
                    harvested = encoder.poll()
                except Exception as e:
                    raise EncoderFault(f"encoder poll failed: {e!r}") from e
                # submit/poll can block the loop for one long stretch
                # (a first-use build); beating after them keeps that from
                # reading as a stall
                sup.beat()
                while errors:
                    errors.popleft()
                    st.ladder.record_failure()
                for _seq, stripes in harvested:
                    # results come in submission order: a span older than
                    # this one was lost inside the encoder (its error was
                    # counted above)
                    while pending_tr and next(iter(pending_tr)) < _seq:
                        recorder.drop(pending_tr.pop(next(iter(pending_tr))),
                                      "encode")
                    tr = pending_tr.pop(_seq, None)
                    if tr is not None and pop_trace is not None:
                        # the encoder-side intervals harvested with the
                        # frame (stage/dispatch/fetch_wait/pack)
                        tr.merge(pop_trace(_seq))
                    if not stripes:
                        # damage gating emitted nothing: a coalesced
                        # frame, closed (not dropped, not acked)
                        if tr is not None:
                            recorder.finish_empty(tr)
                        continue
                    progressed = accepted = True
                    frame_id = FrameId.next(frame_id)
                    try:
                        self._emit_frame(st, frame_id, stripes, encoder, tr)
                    except BaseException:
                        if tr is not None and tr.terminal is None:
                            recorder.drop(tr, "send")
                        raise
                    st.bp.on_frame_sent(frame_id)
                    st.frames_sent += 1
                now = time.monotonic()
                if accepted:
                    accepted_at = now
                elif wedge_s is not None and now - accepted_at > wedge_s:
                    # the loop ticks, nothing moves: force_step tells the
                    # event handler to step the ladder at once (a
                    # consecutive count would be reset by each restart's
                    # first accepted submit and never escalate)
                    raise EncoderFault(
                        f"pipeline wedged: no accepted submits or harvests "
                        f"for {now - accepted_at:.1f}s", force_step=True)
                if st.ladder.failures_total > failures_before:
                    error_ticks += 1
                    if (error_ticks >= st.ladder.fail_threshold
                            and st.ladder.rung == rung):
                        raise EncoderFault(
                            f"persistent encode errors at rung {rung} "
                            f"({error_ticks} consecutive error ticks)")
                elif progressed:
                    error_ticks = 0
                    if st.ladder.record_success():
                        logger.info("display %s probed back up to rung %s",
                                    st.display_id, st.ladder.rung)
                if st.ladder.rung != rung:
                    # the rung changed under us (errors counted above, or
                    # the probe): exit cleanly; the supervisor restarts
                    # with the new rung's encoder
                    self._broadcast_health()
                    return
                if st.ws is not None and faults.should_fire("ws.drop"):
                    self._spawn_background(st.ws.close(),
                                           f"ws.drop:{st.display_id}")
                next_tick += interval
                delay = next_tick - time.monotonic()
                if delay < -1.0:  # fell badly behind; resynchronize
                    next_tick = time.monotonic()
                    delay = 0.0
                await asyncio.sleep(max(0.0, delay))
        finally:
            if source is not None:
                try:
                    source.stop()
                except Exception:
                    logger.exception("source stop for %s raised",
                                     st.display_id)
            # frames in flight inside the encoder being closed are
            # abandoned with it: a supervised restart, a rung change, a
            # migration's rebuild or a stop never leaks their spans
            for tr in pending_tr.values():
                recorder.drop(tr, "restart")
            pending_tr.clear()
            st.encoder = None
            self._retire(encoder)

    def _acquire_mesh_encoder(self, st: DisplayState, fps: float):
        """A session facade onto the lane scheduler of the display's
        (geometry, profile) bucket when ``tpu_mesh`` is set; None → the
        display's own encoder.

        Lanes serve the ``jpeg`` and ``x264enc-striped`` profiles with the
        server-wide quality settings; the full-frame ``x264enc`` profile,
        a watermark, a failed geometry, the bucket cap or no free slot
        fall back to a solo encoder (counted in ``mesh_stats``)."""
        spec = str(self.settings.tpu_mesh)
        if not spec:
            return None
        profile = self._mesh_profile_of(st.overrides)
        if profile not in ("jpeg", "x264enc-striped"):
            return None
        if str(self.settings.watermark_path):
            # the lane encoders have no watermark stage; a configured
            # watermark must not silently vanish — keep the solo pipeline
            logger.warning(
                "tpu_mesh ignored for %s: watermark_path requires the solo "
                "JPEG pipeline", st.display_id)
            return None
        geom = (st.width, st.height, profile)
        if geom in self._mesh_failed_geoms:
            self.mesh_stats["solo_fallback"] += 1
            return None
        coord = self.mesh_coordinators.get(geom)
        if coord is None:
            if len(self.mesh_coordinators) >= MESH_BUCKET_CAP:
                self.mesh_stats["solo_fallback"] += 1
                logger.warning(
                    "lanes: bucket limit reached; %s at %dx%d uses a solo "
                    "encoder", st.display_id, *geom[:2])
                return None
            try:
                from ..parallel.coordinator import (LaneTicker,
                                                    MeshEncodeCoordinator)

                if self._lane_ticker is None:
                    self._lane_ticker = LaneTicker()
                factory = self.coordinator_factory or MeshEncodeCoordinator
                coord = factory(
                    spec, int(self.settings.tpu_sessions_per_chip),
                    st.width, st.height, settings=self.settings,
                    framerate=fps, profile=profile, device=self.device,
                    ticker=self._lane_ticker)
                # mesh.tick_raise / mesh.slot_raise check the server's
                # injector at the scheduler's sites
                coord.faults = self.faults
                self.mesh_coordinators[geom] = coord
                logger.info(
                    "lanes: %s → %s session slots/lane (max %s lanes) at "
                    "%dx%d (bucket %d)", spec,
                    getattr(coord, "slots_per_lane", "?"),
                    getattr(coord, "max_lanes", "?"), st.width, st.height,
                    len(self.mesh_coordinators))
            except Exception:
                logger.exception(
                    "lane scheduler for %dx%d (%s) unavailable; that "
                    "geometry uses solo encoders", *geom)
                self._mesh_failed_geoms.add(geom)
                self.mesh_stats["solo_fallback"] += 1
                return None
        facade = coord.acquire(st.width, st.height)
        if facade is None:
            # races the admission verdict lost (two joins for the last
            # slot) land here: serve them solo rather than dropping a
            # session the front door already admitted
            self.mesh_stats["solo_fallback"] += 1
            logger.warning("lanes: no slot for %s at %dx%d; solo encoder",
                           st.display_id, st.width, st.height)
        else:
            self.mesh_stats["bucketed"] += 1
        return facade

    def _emit_frame(self, st: DisplayState, frame_id: int, stripes,
                    encoder, tr=None) -> None:
        """Wire-pack one harvested frame and fan it out to the display's
        viewers through their send queues.

        Flight recorder: the LAST stripe of a traced frame rides the
        owner's send queue with the trace attached (the frame is decodable
        when that stripe lands), closing queue/send there and registering
        the span for CLIENT_FRAME_ACK; every path with no delivery to the
        owner (no viewers, evicted owner, ownerless display) closes the
        span terminally instead."""
        recorder = self.recorder
        viewers = self._viewers_of(st.display_id)
        owner = st.ws
        owner_cq = self._send_queues.get(owner) if owner is not None else None
        if tr is not None:
            tr.frame_id = frame_id
        n = len(stripes)
        for i, s in enumerate(stripes):
            if not viewers:
                break
            chunk = _pack_stripe(frame_id, s, encoder)
            if tr is not None and i == n - 1 and owner in viewers:
                others = viewers - {owner}
                if others:
                    self._fanout(others, chunk)
                if owner_cq is not None and not owner_cq.evicted:
                    owner_cq.offer_traced(chunk, tr)
                elif owner_cq is not None:
                    # evicted mid-kill: the frame never reaches the owner
                    recorder.drop(tr, "queue")
                else:
                    # no send queue (a client registered outside
                    # ws_handler): direct fan-out, zero queue dwell
                    t0 = time.monotonic()
                    _ws_broadcast({owner}, chunk)
                    t1 = time.monotonic()
                    tr.mark("queue", t0, t0)
                    tr.mark("send", t0, t1)
                    recorder.sent(tr)
            else:
                self._fanout(viewers, chunk)
            self.bytes_sent += len(chunk) * len(viewers)
        if tr is not None and tr.terminal is None and not (
                viewers and owner is not None and owner in viewers):
            # encoded, but nobody to ACK it: close rather than wait
            recorder.drop(tr, "send")

    async def _backpressure_loop(self, st: DisplayState) -> None:
        sup = st.bp_supervisor
        while True:
            await asyncio.sleep(CHECK_INTERVAL_S)
            sup.beat()
            st.bp.evaluate()

    # ------------------------------------------------------------------
    # supervision events + health feed

    def _spawn_background(self, coro, name: str) -> None:
        """Run a fire-and-forget coroutine with a held reference and
        logged (not warned-at-GC) exceptions."""
        async def runner():
            try:
                await coro
            except Exception:
                logger.debug("background task %s failed", name,
                             exc_info=True)
        task = asyncio.create_task(runner())
        self._bg_tasks.add(task)
        task.add_done_callback(self._bg_tasks.discard)

    def _on_supervisor_event(self, st: DisplayState, kind: str,
                             info: Any) -> None:
        """Ladder and health fan-out for supervisor lifecycle events (runs
        on the event loop; must never raise)."""
        if kind == "failure" and isinstance(info, EncoderFault):
            force_step = info.force_step
            stepped = (st.ladder.force_step_down() if force_step
                       else st.ladder.record_failure())
            if stepped:
                st.wedge_faults = 0
                logger.warning("display %s degraded to rung %s",
                               st.display_id, st.ladder.rung)
                if st.supervisor is not None:
                    # the ladder absorbed this failure streak; judge the
                    # new rung against a fresh budget, or probe cycles
                    # would terminally fail a healthy degraded display
                    st.supervisor.forgive()
            elif force_step:
                # wedged with nowhere left to degrade: each rebuild of a
                # hung encoder may abandon a blocked thread, so bound the
                # cycle instead of leaking threads forever
                st.wedge_faults += 1
                if st.wedge_faults >= 3:
                    logger.error(
                        "display %s wedged %d times at the bottom rung; "
                        "marking failed", st.display_id, st.wedge_faults)
                    kind = "failed"
        if self.metrics is not None:
            if kind == "restart":
                self.metrics.inc_supervisor_restart()
            elif kind == "watchdog":
                self.metrics.inc_watchdog_restart()
        if kind == "failed":
            # a failed capture pipeline must not leave its sibling
            # backpressure loop ticking; tear the display down from
            # outside the supervisor task that emitted the event
            # (stopping it inline would await the task we are inside of)
            st.failed = True
            self._spawn_background(self._teardown_failed_display(st),
                                   f"teardown-failed:{st.display_id}")
        self._broadcast_health()

    async def _teardown_failed_display(self, st: DisplayState) -> None:
        async with st.lock:
            if not st.failed:
                # an explicit START_VIDEO/SETTINGS restarted the display
                # before this queued teardown ran: it is healthy again
                return
            await self._stop_display_locked(st)

    def _failed_displays(self) -> int:
        return sum(1 for d in self.display_clients.values()
                   if d.failed or (d.supervisor is not None
                                   and d.supervisor.state == FAILED))

    def _health_payload(self) -> str:
        """The ``system,health`` wire message: per-display supervision,
        watchdog and degradation-ladder state with the flight recorder's
        stage breakdown over the last minute (``stages``, and the
        glass-to-glass and encode-only p50s), and the lane scheduler's
        slot health per bucket (``mesh``) — the JAX server's keys."""
        displays: Dict[str, Any] = {}
        for did, st in self.display_clients.items():
            sup = st.supervisor.stats() if st.supervisor is not None else {}
            d: Dict[str, Any] = {
                "rung": st.ladder.rung,
                "ladder": st.ladder.state(),
                "failed": st.failed,
                "supervisor": sup.get("state",
                                      "failed" if st.failed else "idle"),
                "restarts": sup.get("restarts_total", 0),
                "failures": sup.get("failures_total", 0),
                "watchdog_restarts": sup.get("watchdog_restarts_total", 0),
            }
            enc = st.encoder
            if enc is not None and hasattr(enc, "stats"):
                est = enc.stats()
                d["frames_dropped"] = est.get("frames_dropped", 0)
                d["encode_errors"] = est.get("encode_errors", 0)
            # where each frame's time went, for the client's overlay
            summ = self.recorder.summary(did, last_s=60.0)
            if summ.get("stages"):
                d["stages"] = {
                    stage: {"p50_ms": v["p50_ms"], "p95_ms": v["p95_ms"]}
                    for stage, v in summ["stages"].items()}
                for k in ("glass_to_glass_p50_ms", "encode_only_p50_ms"):
                    if k in summ:
                        d[k] = summ[k]
            displays[did] = d
        # slot health per bucket: a quarantined slot or a live migration
        # must reach the client overlay, not only the scheduler's stats()
        mesh: Dict[str, Any] = {}
        for (w, h, profile), coord in list(self.mesh_coordinators.items()):
            try:
                cs = coord.stats()
            except Exception:
                continue
            mesh[f"{w}x{h}/{profile}"] = {
                "active_sessions": cs.get("active_sessions", 0),
                "lanes": cs.get("lanes", 0),
                "capacity_slots": cs.get("capacity_slots", 0),
                "free_slots": cs.get("free_slots", 0),
                "quarantined_slots": cs.get("quarantined_slots", 0),
                "slot_errors": cs.get("slot_errors", []),
                "tick_errors_total": cs.get("tick_errors_total", 0),
                "worker_restarts_total":
                    cs.get("worker_restarts_total", 0),
                "inflight_batches": cs.get("inflight_batches", 0),
                "migrations_total": cs.get("migrations_total", 0),
                # a lane spans one card (no split-frame encoding)
                "sfe_shards": 1,
                "sfe_concat_ms_p50": cs.get("sfe_concat_ms_p50", 0.0),
                "lane_detail": cs.get("lane_detail", []),
            }
        return pack_system_health(displays, mesh=mesh or None)

    def _publish_health_metrics(self) -> None:
        """Recompute the health gauges from current state: recovery and
        display removal must clear them, not only events raise them."""
        if self.metrics is None:
            return
        levels = [d.ladder.level for d in self.display_clients.values()]
        self.metrics.set_degradation_rung(max(levels) if levels else 0)
        self.metrics.set_failed_displays(self._failed_displays())

    def _broadcast_health(self) -> None:
        try:
            self._publish_health_metrics()
            self.broadcast(self._health_payload())
        except Exception:
            logger.exception("health broadcast failed")

    def _update_load_shed(self) -> None:
        """Admission-control load shedding (stats-tick cadence): when the
        encode pipelines report sustained frame drops — the card can no
        longer keep up with the admitted load — stop admitting new
        connections until the drop rate recovers. Existing sessions keep
        their backpressure and degradation; shedding only protects them
        from more load."""
        threshold = int(self.settings.shed_drop_threshold or 0)
        if threshold <= 0:
            self._load_shedding = False
            return
        total = 0
        for st in self.display_clients.values():
            enc = st.encoder
            if enc is not None and hasattr(enc, "stats"):
                try:
                    total += int(enc.stats().get("frames_dropped", 0))
                except Exception:
                    pass
        delta = total - self._last_dropped_total
        if delta < 0:
            # a supervised restart replaced an encoder (its cumulative
            # counter restarted from zero): the new encoder's drops are
            # all new drops
            delta = total
        self._last_dropped_total = total
        if delta >= threshold:
            self._shed_strikes += 1
        else:
            self._shed_strikes = 0
        shedding = self._shed_strikes >= 2
        if shedding != self._load_shedding:
            logger.warning(
                "load shedding %s (%d frames dropped this tick, "
                "threshold %d)",
                "engaged" if shedding else "released", delta, threshold)
        self._load_shedding = shedding

    async def set_framerate(self, fps: float) -> None:
        """Apply a new target framerate to every active display (each
        running pipeline restarts with it)."""
        fps = float(self.settings.framerate.clamp(int(fps)))
        for st in list(self.display_clients.values()):
            st.bp.framerate = fps
            if st.capture_task is not None and not st.capture_task.done():
                await self.reconfigure_display(st)

    # ------------------------------------------------------------------
    # file upload (path-sanitized)

    async def _on_upload_start(self, websocket, args) -> None:
        if "upload" not in self.settings.file_transfers:
            await websocket.send("FILE_UPLOAD_ERROR:GENERAL:uploads disabled")
            return
        try:
            rel_path = args[0]
            size = int(args[1]) if len(args) > 1 and args[1] else 0
        except (ValueError, IndexError):
            await websocket.send("FILE_UPLOAD_ERROR:GENERAL:bad upload header")
            return
        root = os.path.realpath(upload_dir())
        norm = os.path.normpath(rel_path)
        if norm.startswith(("/", "\\")) or ".." in norm.split(os.sep) \
                or any(ord(c) < 0x20 or c in '"\x7f' for c in norm):
            # control characters and quotes in names would otherwise reach
            # the file listing and Content-Disposition planes
            await websocket.send(f"FILE_UPLOAD_ERROR:{rel_path}:invalid path")
            return
        target = os.path.realpath(os.path.join(root, norm))
        if not target.startswith(root + os.sep):
            await websocket.send(f"FILE_UPLOAD_ERROR:{rel_path}:invalid path")
            return
        os.makedirs(os.path.dirname(target), exist_ok=True)
        old = self._uploads.pop(websocket, None)
        if old:
            # superseded mid-flight: remove the truncated partial too
            self._abort_upload(old)
        self._uploads[websocket] = _Upload(
            path=target, rel_path=rel_path, fobj=open(target, "wb"), size=size)
        logger.info("upload started: %s (%d bytes)", target, size)

    # ------------------------------------------------------------------
    # command execution

    async def _run_command(self, command: str) -> None:
        logger.info("exec: %s", command)
        try:
            await asyncio.create_subprocess_shell(
                command,
                stdout=asyncio.subprocess.DEVNULL,
                stderr=asyncio.subprocess.DEVNULL,
            )
        except OSError as e:
            logger.warning("command failed to spawn: %s", e)

    # ------------------------------------------------------------------
    # stats feed

    async def _retire_idle_buckets(self) -> None:
        """Stop and drop the lane scheduler of a bucket that has had no
        session for its ``lane_retire_s``. A scheduler keeps its last lane
        warm for the next joiner, so without this a geometry that displays
        resized away from would hold its lane's device planes for good
        (and a slot of the MESH_BUCKET_CAP). The JAX server keeps every
        bucket it built."""
        now = time.monotonic()
        for geom, coord in list(self.mesh_coordinators.items()):
            if coord.active_sessions:
                self._bucket_idle_since.pop(geom, None)
                continue
            since = self._bucket_idle_since.setdefault(geom, now)
            if now - since >= coord.lane_retire_s:
                del self.mesh_coordinators[geom]
                del self._bucket_idle_since[geom]
                await asyncio.to_thread(coord.stop)   # joins its thread
                logger.info("lanes: bucket %dx%d (%s) retired, no session "
                            "for %.1fs", *geom, now - since)

    async def _stats_loop(self) -> None:
        prev_bytes = 0
        while True:
            await asyncio.sleep(STATS_INTERVAL_S)
            try:
                self._update_load_shed()
                # flight-recorder upkeep: late metrics attachment and the
                # expiry sweep (a client that never ACKs must not pin
                # open spans)
                self.recorder.metrics = self.metrics
                self.recorder.expire()
                if self.metrics is not None:
                    self.metrics.set_trace_open_spans(
                        self.recorder.open_spans())
                    self.metrics.set_backpressured(sum(
                        1 for d in self.display_clients.values()
                        if not d.bp.send_enabled))
                    self.metrics.set_send_queue_depth(max(
                        (len(cq.q) for cq in self._send_queues.values()),
                        default=0))
                    self._publish_health_metrics()
                await self._retire_idle_buckets()
                self.broadcast(json.dumps(self._collect_system_stats()))
                net = {
                    "type": "network_stats",
                    "bytes_sent_delta": self.bytes_sent - prev_bytes,
                    "interval_s": STATS_INTERVAL_S,
                }
                if self.mesh_coordinators or self.mesh_stats["solo_fallback"]:
                    # lane fallbacks must be observable, not silent;
                    # "bucketed" is a cumulative acquisition counter, live
                    # occupancy is reported apart
                    coords = list(self.mesh_coordinators.values())
                    net["mesh_buckets"] = len(coords)
                    net["mesh_acquisitions_total"] = \
                        self.mesh_stats["bucketed"]
                    net["mesh_sessions"] = sum(c.active_sessions
                                               for c in coords)
                    net["mesh_solo_fallbacks"] = \
                        self.mesh_stats["solo_fallback"]
                    net["mesh_tick_errors"] = sum(c.tick_errors_total
                                                  for c in coords)
                    net["mesh_worker_restarts"] = sum(
                        c.worker_restarts_total for c in coords)
                    sched = self.scheduler_stats()
                    if sched is not None:
                        net["mesh_lanes"] = sched["lanes"]
                        net["mesh_slots_free"] = sched["slots_free"]
                        net["mesh_quarantined_slots"] = \
                            sched["quarantined_slots"]
                    net["mesh_migrations_total"] = sum(
                        c.migrations_total for c in coords)
                    if self.metrics is not None:
                        coord_stats = [c.stats() for c in coords]
                        self.metrics.set_mesh_health(
                            active_sessions=net["mesh_sessions"],
                            lanes=net.get("mesh_lanes", 0),
                            inflight=sum(cs.get("inflight_batches", 0)
                                         for cs in coord_stats),
                            slot_errors=sum(sum(cs.get("slot_errors", []))
                                            for cs in coord_stats),
                            tick_errors=net["mesh_tick_errors"],
                            worker_restarts=net["mesh_worker_restarts"],
                            quarantined=net.get("mesh_quarantined_slots", 0),
                            migrations=net["mesh_migrations_total"])
                        # a lane spans one card (no split-frame encoding)
                        self.metrics.set_sfe_health(shards=0,
                                                    concat_ms_p50=0.0)
                edge = self.edge_stats
                if (edge["protocol_errors"] or edge["rate_limited"]
                        or edge["sessions_rejected"]
                        or edge["sessions_queued"]
                        or edge["slow_client_evictions"]):
                    # hostile-client activity rides the stats feed so a
                    # dashboardless operator still sees it
                    net["edge"] = {
                        "protocol_errors": edge["protocol_errors"],
                        "rate_limited": dict(edge["rate_limited"]),
                        "sessions_rejected": edge["sessions_rejected"],
                        "sessions_queued": edge["sessions_queued"],
                        "slow_client_evictions":
                            edge["slow_client_evictions"],
                        "load_shedding": self._load_shedding,
                    }
                prev_bytes = self.bytes_sent
                self.broadcast(json.dumps(net))
                if self.display_clients:
                    self._broadcast_health()
                gpu = self._collect_gpu_stats()
                if gpu:
                    self.broadcast(json.dumps(gpu))
            except Exception:
                logger.exception("stats loop error")

    def _collect_system_stats(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"type": "system_stats"}
        try:
            import psutil

            out["cpu_percent"] = psutil.cpu_percent()
            mem = psutil.virtual_memory()
            out["mem_total"] = mem.total
            out["mem_used"] = mem.used
        except ImportError:
            la1, _, _ = os.getloadavg()
            out["load_1m"] = la1
        return out

    def _collect_gpu_stats(self) -> Optional[Dict[str, Any]]:
        """The card's memory for the client's overlay (the JAX server's
        TPU occupancy keys): the caching allocator's bytes in use on the
        server's card and the card's total memory. Neither read waits on
        a stream; None when the server runs on the CPU."""
        import torch

        dev = torch.device(self.device if self.device is not None
                           else "cuda")
        if dev.type != "cuda" or not torch.cuda.is_available():
            return None
        _free, total = torch.cuda.mem_get_info(dev)
        return {"type": "gpu_stats",
                "device_count": torch.cuda.device_count(),
                "platform": "gpu",
                "bytes_in_use": torch.cuda.memory_allocated(dev),
                "bytes_limit": total}

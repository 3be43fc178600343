"""The WebSocket data server, reduced to the video path of the websockets mode.

Counterpart of ``selkies_tpu/server/data_server.py``. What this slice keeps:

* the ``ws_handler`` handshake — ``SETTINGS,{json}`` in; ``MODE
  websockets`` and the ``server_settings`` JSON out;
* starting a display on ``SETTINGS`` and running its capture loop: source
  frames → the encoder's ``try_submit``/``poll`` → 0x03 JPEG stripes, 0x04
  H.264 stripes for ``x264enc-striped`` or 0x00 full frames for
  ``x264enc``, fanned out to the display's viewers;
* supervision (``robustness/``): each display's capture and backpressure
  loops run under a :class:`~..robustness.Supervisor` (bounded-backoff
  restarts, a restart budget over a sliding window, a frame-deadline
  watchdog); encoder failures step the display's
  :class:`~..robustness.DegradationLadder` (device → host → jpeg, every
  rung on the card) and a clean window probes it back up; a display whose
  budget runs out fails alone and is torn down; the ``system_health``
  feed tells the clients; fault points (``SELKIES_TPU_FAULTS``) are
  checked at the JAX server's call sites;
* ``CLIENT_FRAME_ACK`` and ``_f`` into the display's
  :class:`~.backpressure.BackpressureState`, re-evaluated every
  ``CHECK_INTERVAL_S``; ``START_VIDEO``/``STOP_VIDEO``;
* multi-session lanes (``tpu_mesh``): with a mesh spec, a display of the
  ``jpeg`` or ``x264enc-striped`` profile at its ``device`` rung rides a
  slot of a lane (``parallel/``; one scheduler per geometry and profile)
  instead of its own encoder; a new display is admitted, queued or shed
  (``KILL server_full``) by the lanes' live capacity, and a session the
  scheduler migrates off a sick slot restarts its frame ids
  (``PIPELINE_RESETTING``) with its restart budget forgiven;
* close.

Uploads, input, resize/reconfigure, stats, metrics, the flight recorder
and the wire edge's rate limits and load shedding are not ported yet. An
unknown encoder profile raises.

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

from ..protocol.wire import (
    FrameId,
    pack_full_frame,
    pack_h264_stripe,
    pack_jpeg_stripe,
    pack_system_health,
    parse_text_message,
)
from ..robustness import (FAILED, DegradationLadder, EncoderFault,
                          FaultInjector, Supervisor, backoff_delay)
from ..settings import SETTING_DEFINITIONS, Settings
from .backpressure import CHECK_INTERVAL_S, BackpressureState

logger = logging.getLogger("selkies_tpu_torch.server")

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


def default_source_factory(width: int, height: int, fps: float):
    """Synthetic desktop capture (X11 capture is not ported yet)."""
    from ..capture.synthetic import SyntheticSource

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
    bp: BackpressureState = field(default_factory=BackpressureState)
    #: serializes start/stop (they await mid-flight)
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
    #: (width, height) and (overrides, framerate) the running pipeline was
    #: started with: a SETTINGS from its owner that changes neither keeps
    #: it streaming
    running_geom: Optional[Tuple[int, int]] = None
    running_config: Optional[Tuple[Dict[str, Any], float]] = None


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
        encoder_factory: Callable = default_encoder_factory,
        source_factory: Callable = default_source_factory,
        host: str = "0.0.0.0",
        device=None,
    ) -> None:
        self.settings = settings
        self.encoder_factory = encoder_factory
        self.source_factory = source_factory
        self.host = host
        self.port = settings.port
        #: device the encoders run on (None → the card, raising without one)
        self.device = device
        self.clients: Set[Any] = set()
        self.display_clients: Dict[str, DisplayState] = {}
        self._stop_event: Optional[asyncio.Event] = None
        #: closed encoders whose threads may still run; pruned at every
        #: capture-loop start, joined by stop()
        self._retired: list = []
        #: fault-injection registry, armed from the tpu_faults setting
        #: (SELKIES_TPU_FAULTS) and checked at the real call sites
        self.faults = FaultInjector(str(settings.tpu_faults or ""))
        #: fire-and-forget helpers (ws.drop closes, failed-display
        #: teardown), referenced so they are not collected mid-flight
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
        #: display-plane admission: joins queued for a lane slot, and
        #: joins shed with KILL server_full
        self.edge_stats: Dict[str, int] = {"sessions_queued": 0,
                                           "sessions_rejected": 0}

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
        if self._stop_event:
            self._stop_event.set()

    # ------------------------------------------------------------------
    # display-plane admission: scheduler verdicts (docs/scaling.md)

    def _mesh_profile_of(self, overrides: Dict[str, Any]) -> str:
        return str(overrides.get("encoder", self.settings.encoder))

    def _display_admission_verdict(self, width: int, height: int,
                                   overrides: Dict[str, Any]) -> str:
        """``admit`` / ``queue`` / ``shed`` for a NEW display join.

        The flat ``max_displays`` cap is the hard backstop; below it the
        verdict comes from live lane capacity: a join whose geometry
        bucket has a free or growable slot is admitted, a join into a
        momentarily full scheduler queues (leave churn frees slots within
        the queue window), and a full scheduler sheds. Displays the lanes
        cannot serve (other profiles, watermark, failed geometries) are
        admitted toward their solo pipelines, and ``mesh_overflow_solo``
        sends overflow to solo pipelines wholesale. (The JAX server also
        sheds while its wire edge is load shedding; the port has no load
        shedding yet.)"""
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

    # ------------------------------------------------------------------
    # connection handling

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
        return self.display_clients.get("primary")

    async def ws_handler(self, websocket) -> None:
        self.clients.add(websocket)
        primary = self.display_clients.get("primary")
        if primary is not None and primary.encoder is not None:
            # late-joining viewer: damage gating would never send it the
            # static content, so the next frame refreshes every stripe
            primary.encoder.force_keyframe()
        try:
            await websocket.send("MODE websockets")
            await websocket.send(json.dumps(self.settings.schema_payload()))
            async for message in websocket:
                if isinstance(message, (bytes, bytearray)):
                    logger.debug("client binary frames are not served yet")
                    continue
                try:
                    await self._handle_text(websocket, message)
                except Exception as e:
                    if (isinstance(e, ConnectionError)
                            or type(e).__name__.startswith("ConnectionClosed")):
                        raise
                    # a malformed message costs only itself
                    logger.debug("dropped client message: %r", e)
        except Exception as e:
            logger.debug("ws session ended: %r", e)
        finally:
            self.clients.discard(websocket)
            for st in list(self.display_clients.values()):
                if st.ws is websocket:
                    del self.display_clients[st.display_id]
                    await self._stop_display(st)

    async def _handle_text(self, websocket, message: str) -> None:
        msg = parse_text_message(message)
        verb = msg.verb
        st = self._display_of(websocket)
        owner = st is not None and st.ws is websocket
        if verb == "SETTINGS":
            await self._on_settings(websocket, msg.json_body or "{}")
        elif verb == "CLIENT_FRAME_ACK":
            # only the display's owner acks
            if owner and msg.args:
                try:
                    st.bp.on_client_ack(int(msg.args[0]))
                except ValueError:
                    pass
        elif verb == "_f":
            if owner and msg.args:
                try:
                    st.bp.on_client_fps(float(msg.args[0]))
                except ValueError:
                    pass
        elif verb == "START_VIDEO":
            if owner:
                st.video_active = True
                await self._start_display(st)
                _ws_broadcast({websocket}, "VIDEO_STARTED")
        elif verb == "STOP_VIDEO":
            if owner:
                st.video_active = False
                await self._stop_display(st)
                _ws_broadcast({websocket}, "VIDEO_STOPPED")
        else:
            logger.debug("verb %r is not served by this slice", verb)

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
        # itself
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
        if st is None:
            # admission control on the display plane: each display is a
            # capture+encode pipeline, far heavier than a viewer — the
            # verdict comes from live lane capacity (admit / queue /
            # shed), with max_displays as the hard backstop above it
            verdict = self._display_admission_verdict(
                width or 1024, height or 768, applied)
            if verdict == "queue":
                verdict = await self._await_display_admission(
                    width or 1024, height or 768, applied)
            if verdict != "admit":
                self.edge_stats["sessions_rejected"] += 1
                logger.warning("display %s rejected (%s): %d displays live",
                               display_id, verdict, len(self.display_clients))
                await websocket.send("KILL server_full")
                await websocket.close()
                return
            # the queue wait yields the loop: another handshake may have
            # registered this display meanwhile — adopt it (superseding
            # its client below), don't clobber it
            st = self.display_clients.get(display_id)
        same_owner = st is not None and st.ws is websocket
        if st is not None and st.ws is not None and not same_owner:
            try:
                await st.ws.send("KILL Display taken over by another client.")
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
        async with st.lock:
            running = (st.capture_task is not None
                       and not st.capture_task.done())
            if (same_owner and running
                    and st.running_geom == (st.width, st.height)
                    and st.running_config == (st.overrides,
                                              st.bp.framerate)):
                return          # started with these settings: keep it
            # settings define the pipeline: (re)start it with them
            await self._stop_display_locked(st)
            if st.video_active:
                await self._start_display_locked(st)

    # ------------------------------------------------------------------
    # capture / encode pipeline per display

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
        st.running_geom = (st.width, st.height)
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
        message = f"PIPELINE_RESETTING {st.display_id}"
        targets = self._viewers_of(st.display_id)
        if targets:
            _ws_broadcast(targets, message)

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
        st.encoder = encoder
        source = None
        try:
            sup.beat()   # encoder construction counts as progress
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
                    frame = source.next_frame()
                    if frame is not None:
                        try:
                            faults.maybe_raise("encode.raise")
                            # None = dropped (pipeline full)
                            accepted = encoder.try_submit(frame) is not None
                        except Exception as e:
                            raise EncoderFault(
                                f"encoder submit failed: {e!r}") from e
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
                    if not stripes:
                        continue        # damage gating emitted nothing
                    progressed = accepted = True
                    frame_id = FrameId.next(frame_id)
                    self._emit_frame(st, frame_id, stripes, encoder)
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
                from ..parallel.coordinator import MeshEncodeCoordinator

                factory = self.coordinator_factory or MeshEncodeCoordinator
                coord = factory(
                    spec, int(self.settings.tpu_sessions_per_chip),
                    st.width, st.height, settings=self.settings,
                    framerate=fps, profile=profile, device=self.device)
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
                    encoder) -> None:
        viewers = self._viewers_of(st.display_id)
        if not viewers:
            return
        for s in stripes:
            _ws_broadcast(viewers, _pack_stripe(frame_id, s, encoder))

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
        watchdog and degradation-ladder state, and the lane scheduler's
        slot health per bucket (``mesh``) — the JAX server's keys, less
        the flight recorder's ``stages``, not ported yet."""
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

    def _broadcast_health(self) -> None:
        try:
            if self.clients:
                _ws_broadcast(set(self.clients), self._health_payload())
        except Exception:
            logger.exception("health broadcast failed")

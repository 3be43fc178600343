"""The WebSocket data server, reduced to the video path of the websockets mode.

Counterpart of ``selkies_tpu/server/data_server.py``. What this slice keeps:

* the ``ws_handler`` handshake — ``SETTINGS,{json}`` in; ``MODE
  websockets`` and the ``server_settings`` JSON out;
* starting a display on ``SETTINGS`` and running its capture loop: source
  frames → the encoder's ``try_submit``/``poll`` → 0x03 JPEG stripes, 0x04
  H.264 stripes for ``x264enc-striped`` or 0x00 full frames for
  ``x264enc``, fanned out to the display's viewers;
* ``CLIENT_FRAME_ACK`` and ``_f`` into the display's
  :class:`~.backpressure.BackpressureState`, re-evaluated every
  ``CHECK_INTERVAL_S``; ``START_VIDEO``/``STOP_VIDEO``;
* close.

Uploads, input, resize/reconfigure, the mesh, health/stats, supervisors,
the degradation ladder and the flight recorder are not ported yet. There
is no fallback either: an unknown encoder profile raises, and a
capture-loop error (a frame lost to the encoder included) ends the server
(:meth:`run_server` raises it) rather than leaving a display that streams
nothing.

Concurrency model (same invariant as the JAX server): one asyncio loop
owns all mutable state; the encoder is driven with non-blocking submits and
polls (``AsyncEncodeDriver``), so the loop never waits on the device.
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
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Set

from ..protocol.wire import (
    FrameId,
    pack_full_frame,
    pack_h264_stripe,
    pack_jpeg_stripe,
    parse_text_message,
)
from ..settings import SETTING_DEFINITIONS, Settings
from .backpressure import CHECK_INTERVAL_S, BackpressureState

logger = logging.getLogger("selkies_tpu_torch.server")

#: largest accepted client display dimension (one frame stays < ~200 MB)
MAX_DISPLAY_DIM = 8192



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
    video_active: bool = True
    #: clamped per-client setting overrides from the SETTINGS handshake
    overrides: Dict[str, Any] = field(default_factory=dict)
    #: live encoder of the running capture loop (keyframe kicks)
    encoder: Any = None
    #: frames sent since the capture loop (re)started
    frames_sent: int = 0


class DataStreamingServer:
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
        #: closed encoders whose driver threads stop() waits for
        self._retired: list = []
        #: the error that ended a capture loop; run_server raises it
        self.fatal: Optional[BaseException] = None

    # ------------------------------------------------------------------
    # lifecycle

    async def run_server(self) -> None:
        """Serve until :meth:`stop`, or until an encoder error, which it
        raises."""
        import websockets.asyncio.server as ws_server

        self._stop_event = asyncio.Event()
        cap_mb = int(getattr(self.settings, "max_ws_message_mb", 0))
        max_size = cap_mb * 1024 * 1024 if cap_mb > 0 else None
        async with ws_server.serve(self.ws_handler, self.host, self.port,
                                   compression=None, max_size=max_size):
            logger.info("data server listening on %s:%d", self.host, self.port)
            await self._stop_event.wait()
        if self.fatal is not None:
            raise self.fatal

    async def stop(self) -> None:
        for st in list(self.display_clients.values()):
            await self._stop_display(st)
        # closed encoders' driver threads finish their last device call
        # off the loop; shutdown waits for them (bounded)
        retired, self._retired = self._retired, []
        for enc in retired:
            join = getattr(enc, "join", None)
            if join is not None:
                await asyncio.to_thread(join, 10.0)
        if self._stop_event:
            self._stop_event.set()

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
        if st is not None and st.ws is not None and st.ws is not websocket:
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
        # settings define the pipeline: (re)start it with them
        await self._stop_display(st)
        if st.video_active:
            await self._start_display(st)

    # ------------------------------------------------------------------
    # capture / encode pipeline per display

    async def _start_display(self, st: DisplayState) -> None:
        async with st.lock:
            if self.display_clients.get(st.display_id) is not st:
                return          # deregistered while this start was pending
            if st.capture_task and not st.capture_task.done():
                return
            st.capture_task = asyncio.create_task(self._capture_loop(st))
            st.backpressure_task = asyncio.create_task(
                self._backpressure_loop(st))

    async def _stop_display(self, st: DisplayState) -> None:
        async with st.lock:
            for attr in ("capture_task", "backpressure_task"):
                task = getattr(st, attr)
                if task:
                    task.cancel()        # no-op on a task that has ended
                    try:
                        await task
                    except asyncio.CancelledError:
                        pass
                    except Exception:
                        logger.exception("%s of %s raised",
                                         attr, st.display_id)
                setattr(st, attr, None)

    async def _reset_frame_ids_and_notify(self, st: DisplayState) -> None:
        st.bp.reset()
        message = f"PIPELINE_RESETTING {st.display_id}"
        targets = self._viewers_of(st.display_id)
        if targets:
            _ws_broadcast(targets, message)

    async def _capture_loop(self, st: DisplayState) -> None:
        """Source frames → pipelined encode → 0x03/0x04 stripe fan-out.

        Frame ids restart at 1 on every start, announced with
        ``PIPELINE_RESETTING`` so the client and the backpressure gate drop
        the old horizon. An error in the loop, a frame lost to the encoder
        included, ends the loop and the server (:meth:`_fail`): this slice
        has no degradation ladder."""
        fps = st.bp.framerate or 60.0
        await self._reset_frame_ids_and_notify(st)
        st.frames_sent = 0
        encoder = self.encoder_factory(st.width, st.height, self.settings,
                                       dict(st.overrides), device=self.device)
        errors: list = []
        encoder.on_error = errors.append     # driver thread; list is atomic
        st.encoder = encoder
        source = None
        try:
            source = self.source_factory(st.width, st.height, fps)
            source.start()
            frame_id = 0
            interval = 1.0 / fps
            next_tick = time.monotonic()
            logger.info("capture loop started for %s (%dx%d@%g)",
                        st.display_id, st.width, st.height, fps)
            while True:
                if errors:
                    raise RuntimeError(
                        f"encoder of display {st.display_id} failed"
                    ) from errors[0]
                if st.bp.send_enabled:
                    frame = source.next_frame()
                    if frame is not None:
                        encoder.try_submit(frame)   # None = dropped (full)
                for _seq, stripes in encoder.poll():
                    if not stripes:
                        continue        # damage gating emitted nothing
                    frame_id = FrameId.next(frame_id)
                    self._emit_frame(st, frame_id, stripes, encoder)
                    st.bp.on_frame_sent(frame_id)
                    st.frames_sent += 1
                next_tick += interval
                delay = next_tick - time.monotonic()
                if delay < -1.0:  # fell badly behind; resynchronize
                    next_tick = time.monotonic()
                    delay = 0.0
                await asyncio.sleep(max(0.0, delay))
        except Exception as e:
            self._fail(e)
            raise
        finally:
            if source is not None:
                source.stop()
            st.encoder = None
            encoder.close()
            self._retired.append(encoder)

    def _fail(self, exc: BaseException) -> None:
        """Record the first capture-loop error and stop :meth:`run_server`,
        which raises it."""
        logger.error("capture loop failed, stopping the server: %r", exc)
        if self.fatal is None:
            self.fatal = exc
        if self._stop_event is not None:
            self._stop_event.set()

    def _emit_frame(self, st: DisplayState, frame_id: int, stripes,
                    encoder) -> None:
        viewers = self._viewers_of(st.display_id)
        if not viewers:
            return
        for s in stripes:
            _ws_broadcast(viewers, _pack_stripe(frame_id, s, encoder))

    async def _backpressure_loop(self, st: DisplayState) -> None:
        while True:
            await asyncio.sleep(CHECK_INTERVAL_S)
            st.bp.evaluate()

"""Server entry point wiring (counterpart of ``selkies_tpu/server/main.py``).

``_amain`` wires the planes of the websocket mode as the JAX entry point
does: the data server; audio when ``audio_enabled`` and libopus loads; the
input plane (XTEST injection, clipboard, gamepads) and the cursor monitor,
which fall back to in-memory backends when no X display is reachable
(stream-only mode, with a warning); the bundled web client, ``/turn``,
``/health``, ``/files`` and signaling on ``web_port``; ``Metrics`` on
``metrics_port`` with the server's flight recorder behind ``/debug/trace``
and the opt-in ``/debug/jax-trace`` profiler route (a ``torch.profiler``
capture here); then the clipboard poll and cursor tasks, and an orderly
shutdown of all of it. ``websockets`` is imported only when the servers
start, so this module imports on a host without it.

Where the JAX server enables XLA's persistent compile cache, the port
builds its CUDA kernels (and the H.264 profile's g++ coder) at first use
(``build/torch_kernels/``, reused across restarts while the sources are
unchanged). The warm-up stays in the background: it builds the configured
profile's kernels and encodes two 1080p frames in a worker thread while
the server starts, so the first client does not pay for either. A warm-up
that fails ends the process with its error; the server never runs on
without a working encoder. The port takes an explicit ``device``
(``resolve_device``: no card and none asked for raises).
"""

from __future__ import annotations

import asyncio
import logging

import numpy as np

from ..settings import Settings
from .app import StreamingApp
from .data_server import DataStreamingServer, default_encoder_factory

logger = logging.getLogger("selkies_tpu_torch")


def run(settings: Settings, device=None) -> int:
    logging.basicConfig(
        level=logging.DEBUG if settings.debug.value else logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
    )
    return asyncio.run(_amain(settings, device=device)) or 0


def warm_default_geometry(settings: Settings, device=None,
                          width: int = 1920, height: int = 1080) -> None:
    """Build the configured profile's kernels and encode two frames at the
    default geometry (blocking), through the factory's encoder for the
    configured profile and rung: for the H.264 profiles the first is an
    IDR (the host coder's build) and the second a P frame (the motion
    kernel's build). Raises the encoder's error if any of it fails."""
    enc = default_encoder_factory(width, height, settings, device=device)
    errors: list = []
    enc.on_error = errors.append
    try:
        for _ in range(2):
            enc.submit(np.zeros((height, width, 3), np.uint8))
        enc.flush()
    finally:
        enc.close()
        enc.join(10.0)
    if errors:
        raise RuntimeError("encoder warm-up failed") from errors[0]
    logger.info("encoder warm-up done")


def _wire_audio(settings: Settings, server: DataStreamingServer) -> None:
    if not settings.audio_enabled.value:
        return
    try:
        from ..audio import (AudioCaptureSettings, AudioPipeline,
                             opus_available)

        if opus_available():
            server.audio_pipeline = AudioPipeline(server, AudioCaptureSettings(
                device_name=settings.audio_device_name,
                opus_bitrate=int(settings.audio_bitrate),
                use_silence_gate=True))
        else:
            logger.warning("audio disabled: libopus unavailable")
    except Exception:
        logger.exception("audio init failed")


def _wire_input(settings: Settings, app: StreamingApp,
                server: DataStreamingServer):
    """(input handler, cursor monitor); both None if the plane fails."""
    try:
        from ..input import (FakeX11Backend, InputHandler,
                             open_clipboard_backend, open_x11_backend)
        from ..input.cursor import CursorMonitor, open_cursor_source

        backend = open_x11_backend()
        if isinstance(backend, FakeX11Backend):
            logger.warning("no X display: input is injected nowhere "
                           "(stream-only mode)")
        input_handler = InputHandler(
            backend=backend,
            clipboard=open_clipboard_backend(),
            data_server=server,
            enable_clipboard=(
                "true" if settings.clipboard_enabled.value else "false"),
            enable_binary_clipboard=settings.enable_binary_clipboard.value,
        )

        def _on_set_fps(fps: int) -> None:
            app.set_framerate(fps)
            asyncio.get_running_loop().create_task(server.set_framerate(fps))

        input_handler.on_set_fps = _on_set_fps
        server.input_handler = input_handler
        return input_handler, CursorMonitor(open_cursor_source(),
                                            app.send_cursor)
    except Exception as e:      # stream-only mode
        logger.warning("input plane disabled: %s", e)
        return None, None


def _web_server(settings: Settings):
    """The bundled web client + /turn + /health + /files + signaling on
    ``web_port``, or None when the client is not bundled or the plane
    cannot start (no ``websockets``)."""
    try:
        from ..rtc import SignalingServer
        from . import bundled_web_root

        web_root = bundled_web_root()
        if web_root is None:
            logger.warning(
                "web client assets not bundled; HTTP serving disabled")
            return None
        files_root = None
        if "download" in settings.file_transfers:
            from .data_server import upload_dir

            files_root = upload_dir()
        return SignalingServer(
            addr="0.0.0.0", port=int(settings.web_port),
            web_root=web_root,
            files_root=files_root,
            turn_shared_secret=str(settings.turn_shared_secret),
            turn_host=str(settings.turn_host),
            turn_port=str(settings.turn_port),
        )
    except Exception:
        logger.exception("web server init failed")
        return None


def _wire_metrics(settings: Settings, server: DataStreamingServer):
    """``Metrics`` on ``metrics_port`` (0 disables) with the server's
    flight recorder; a busy port logs and disables the endpoint."""
    if int(settings.metrics_port) <= 0:
        return None
    try:
        from ..observability import Metrics

        metrics = Metrics(port=int(settings.metrics_port))
        metrics.recorder = server.recorder
        metrics.jax_trace_enabled = bool(settings.jax_trace_enabled.value)
        metrics.start_http()
        server.metrics = metrics
        server.recorder.metrics = metrics
        return metrics
    except Exception as e:
        logger.warning("metrics disabled: %s", e)
        return None


async def _amain(settings: Settings, device=None) -> int:
    from .._device import resolve_device

    device = resolve_device(device)      # no card and none asked for: raise
    app = StreamingApp(settings)
    server = DataStreamingServer(settings, app=app, device=device)
    app.data_server = server
    warm = asyncio.ensure_future(
        asyncio.to_thread(warm_default_geometry, settings, device))
    _wire_audio(settings, server)
    input_handler, cursor_monitor = _wire_input(settings, app, server)
    tasks = [asyncio.ensure_future(server.run_server())]

    web_server = _web_server(settings)
    if web_server is not None:
        async def _run_web():
            # a busy web port must not take the media plane down
            try:
                await web_server.run()
            except OSError as e:
                logger.error("web server bind failed (%s); client serving "
                             "disabled", e)

        tasks.append(asyncio.ensure_future(_run_web()))
    metrics = _wire_metrics(settings, server)
    if input_handler is not None:
        tasks.append(asyncio.ensure_future(input_handler.run_clipboard_poll()))
    if cursor_monitor is not None:
        tasks.append(asyncio.ensure_future(cursor_monitor.run()))
    try:
        # a failed warm-up or plane ends the process; else this serves
        # until cancelled
        pending = {warm, *tasks}
        while pending:
            done, pending = await asyncio.wait(
                pending, return_when=asyncio.FIRST_EXCEPTION)
            for t in done:
                t.result()
    except (KeyboardInterrupt, asyncio.CancelledError):
        pass
    finally:
        for t in tasks:
            t.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)
        if web_server is not None:
            await web_server.stop()
        if cursor_monitor is not None:
            cursor_monitor.stop()
            cursor_monitor.source.close()
        if input_handler is not None:
            try:
                await input_handler.close()
            except Exception:
                logger.exception("input plane shutdown failed")
        await server.stop()
        if metrics is not None:
            metrics.stop_http()
    return 0

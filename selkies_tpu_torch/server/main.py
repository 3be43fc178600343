"""Server entry point wiring (counterpart of ``selkies_tpu/server/main.py``).

Where the JAX server enables XLA's persistent compile cache, the port
builds its CUDA kernels (and the H.264 profile's g++ coder) at first use
(``build/torch_kernels/``, reused across restarts while the sources are
unchanged). The warm-up stays in the background: it builds the configured
profile's kernels and encodes two 1080p frames in a worker thread while
the server starts, so the first client does not pay for either. A warm-up that fails ends the process with its error; the server
never runs on without a working encoder.
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


async def _amain(settings: Settings, device=None) -> int:
    from .._device import resolve_device

    device = resolve_device(device)      # no card and none asked for: raise
    app = StreamingApp(settings)
    server = DataStreamingServer(settings, app=app, device=device)
    app.data_server = server
    warm = asyncio.ensure_future(
        asyncio.to_thread(warm_default_geometry, settings, device))
    serve = asyncio.ensure_future(server.run_server())
    try:
        # returns when either raises, else when both are done
        await asyncio.wait({warm, serve},
                           return_when=asyncio.FIRST_EXCEPTION)
        if warm.done():
            warm.result()                # a failed warm-up ends the process
        await serve
    except (KeyboardInterrupt, asyncio.CancelledError):
        pass
    finally:
        serve.cancel()
        await server.stop()
    return 0

"""The port's WebRTC-mode entry point (from
``selkies_tpu/server/webrtc_main.py``; parity: legacy
``wr_entrypoint``/``main()``, reference legacy/webrtc.py:330-988): an
in-process signaling+web server, RTC-config monitors feeding TURN
credentials, and the streaming session app that calls the browser peer and
carries the port's H.264 + Opus + the input data channel over the port's
WebRTC stack.

It resolves the device before it starts anything: with no card and none
asked for it raises ``RuntimeError`` at startup. A session that ends on
the signaling side (no peer yet, the peer left) is retried every 2 s; a
session whose pipeline failed ends the process with that error.

Run: ``selkies-tpu-torch-webrtc`` (console script) or
``python -m selkies_tpu_torch.server.webrtc_main``.
"""

from __future__ import annotations

import asyncio
import logging
import os
import sys

from ..settings import Settings

logger = logging.getLogger("selkies_tpu_torch.webrtc_main")


async def _amain(settings: Settings, device=None) -> int:
    from .._device import resolve_device

    device = resolve_device(device)      # no card and none asked for: raise

    from ..input import InputHandler, open_clipboard_backend, open_x11_backend
    from ..rtc import HMACRTCMonitor, SignalingServer
    from .webrtc_app import WebRTCStreamingApp

    from . import bundled_web_root

    signaling = SignalingServer(
        addr="0.0.0.0", port=int(settings.web_port),
        web_root=bundled_web_root(),
        turn_shared_secret=str(settings.turn_shared_secret),
        turn_host=str(settings.turn_host),
        turn_port=str(settings.turn_port),
    )
    tasks = [asyncio.create_task(signaling.run())]

    input_handler = None
    try:
        input_handler = InputHandler(
            backend=open_x11_backend(),
            clipboard=open_clipboard_backend(),
        )
    except Exception as e:
        logger.warning("input plane disabled: %s", e)

    app = WebRTCStreamingApp(settings, input_handler=input_handler,
                             device=device)

    if input_handler is not None:
        # clipboard poll → JSON control object on the input data channel
        # (the browser peer's webrtc.js onmessage handler; parity with
        # the legacy send_clipboard helper, gstwebrtc_app.py:1371-1471)
        import base64

        last_clip = {"msg": None}

        async def _clip_out(data: bytes, mime: str) -> None:
            if mime != "text/plain":
                # the WebRTC control channel carries text clipboard only
                # for now; log instead of silently absorbing the read
                # (the poll's dedup would otherwise suppress a re-copy)
                logger.info("dropping non-text clipboard (%s, %d bytes) "
                            "on the WebRTC control channel", mime,
                            len(data))
                return
            msg = {"type": "clipboard",
                   "data": base64.b64encode(data).decode()}
            # cache: content read before the data channel opens (or
            # between sessions) is re-sent on the next channel open
            # instead of being lost to the poll's dedup
            last_clip["msg"] = msg
            app.send_json(msg)

        def _on_input_open() -> None:
            if last_clip["msg"] is not None:
                app.send_json(last_clip["msg"])

        input_handler.on_clipboard_read = _clip_out
        app.on_input_channel_open = _on_input_open
        tasks.append(asyncio.create_task(
            input_handler.run_clipboard_poll()))

    if str(settings.turn_shared_secret) and str(settings.turn_host):
        monitor = HMACRTCMonitor(
            str(settings.turn_host), str(settings.turn_port),
            str(settings.turn_shared_secret), "selkies")
        monitor.on_rtc_config = lambda stun, turn, cfg: logger.info(
            "RTC config refreshed (%d stun, %d turn)", len(stun), len(turn))
        tasks.append(asyncio.create_task(monitor.start()))

    uri = f"ws://127.0.0.1:{settings.web_port}/ws"
    # the server registers as peer "0" and calls the browser peer "1"
    # (legacy peer-numbering, webrtc.py:563-575); retry while no peer yet
    try:
        while True:
            try:
                await app.run(uri, "0", "1")
            except Exception:
                if app.error is not None:
                    raise                # the pipeline failed: end with it
                logger.exception("webrtc session ended; retrying in 2s")
            await app.stop_pipeline()
            await asyncio.sleep(2.0)
    finally:
        await app.stop_pipeline()
        for t in tasks:
            t.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)
        await signaling.stop()


def main() -> int:
    settings = Settings(argv=sys.argv[1:], env=dict(os.environ))
    logging.basicConfig(
        level=logging.DEBUG if settings.debug.value else logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    try:
        return asyncio.run(_amain(settings))
    except KeyboardInterrupt:
        return 0


if __name__ == "__main__":
    sys.exit(main())

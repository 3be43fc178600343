"""Streaming app shell: cross-cutting client-facing state and broadcasts
(the port's copy of ``selkies_tpu/server/app.py``).

Role parity with the reference's ``SelkiesStreamingApp`` (selkies.py:113-213):
owns encoder/framerate/resolution defaults, the last-sent cursor, and the
clipboard/cursor broadcast helpers (including multipart chunking for large
clipboard payloads).
"""

from __future__ import annotations

import asyncio
import base64
import json
import logging
from typing import Any, Dict, Optional

logger = logging.getLogger("selkies_tpu_torch.app")

CLIPBOARD_CHUNK_SIZE = 512 * 1024


class StreamingApp:
    def __init__(self, settings) -> None:
        self.settings = settings
        self.encoder = settings.encoder
        self.framerate = settings.framerate.default
        self.display_width = 1024
        self.display_height = 768
        self.last_cursor_sent: Optional[Dict[str, Any]] = None
        self.data_server = None  # wired by main()

    # -- broadcast helpers -------------------------------------------------

    def _broadcast(self, message) -> None:
        if self.data_server is not None:
            self.data_server.broadcast(message)

    async def send_clipboard(self, data, mime_type: str = "text/plain") -> None:
        """Clipboard → all clients, multipart above CLIPBOARD_CHUNK_SIZE.

        Wire verbs match the reference client's handler
        (clipboard / clipboard_binary / clipboard_start / clipboard_data /
        clipboard_finish — selkies.py:142-175).
        """
        is_binary = mime_type != "text/plain"
        if is_binary and not self.settings.enable_binary_clipboard.value:
            logger.warning("binary clipboard disabled; dropping %s", mime_type)
            return
        payload = data.encode("utf-8") if isinstance(data, str) else bytes(data)
        if len(payload) < CLIPBOARD_CHUNK_SIZE:
            b64 = base64.b64encode(payload).decode("ascii")
            self._broadcast(
                f"clipboard_binary,{mime_type},{b64}" if is_binary
                else f"clipboard,{b64}")
            return
        self._broadcast(f"clipboard_start,{mime_type},{len(payload)}")
        for off in range(0, len(payload), CLIPBOARD_CHUNK_SIZE):
            chunk = base64.b64encode(
                payload[off:off + CLIPBOARD_CHUNK_SIZE]).decode("ascii")
            self._broadcast(f"clipboard_data,{chunk}")
            await asyncio.sleep(0)
        self._broadcast("clipboard_finish")

    def send_cursor(self, cursor: Dict[str, Any]) -> None:
        """Cursor image/hotspot update → all clients (``cursor,{json}``)."""
        self.last_cursor_sent = cursor
        self._broadcast(f"cursor,{json.dumps(cursor)}")

    def set_framerate(self, framerate: int) -> None:
        self.framerate = int(framerate)

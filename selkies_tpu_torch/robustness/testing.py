"""In-process stand-in for driving the data server without sockets (the
port's copy of ``InProcessClient`` from ``selkies_tpu/robustness/testing.py``).

``data_server._ws_broadcast`` duck-types on ``send_nowait``, and
``ws_handler`` only needs async ``send``/``close`` plus async iteration —
so :class:`InProcessClient` is a full client as far as the server is
concerned. The port's server tests and ``chip_smoke.py`` drive the server
with it.
"""

from __future__ import annotations

import asyncio
from typing import List


class InProcessClient:
    """Just enough websocket surface for ws_handler + _ws_broadcast."""

    def __init__(self) -> None:
        self.sent: List = []
        self.closed = False
        self._incoming: asyncio.Queue = asyncio.Queue()

    # -- server → client ---------------------------------------------------

    async def send(self, message) -> None:
        if self.closed:
            raise ConnectionError("closed")
        self.sent.append(message)

    def send_nowait(self, message) -> None:
        if not self.closed:
            self.sent.append(message)

    # -- client → server ---------------------------------------------------

    def feed(self, message) -> None:
        """Queue a client message for the handler's async iteration."""
        self._incoming.put_nowait(message)

    async def close(self) -> None:
        if not self.closed:
            self.closed = True
            self._incoming.put_nowait(None)

    # -- inspection helpers ------------------------------------------------

    def binary(self) -> List[bytes]:
        return [m for m in self.sent if isinstance(m, (bytes, bytearray))]

    def texts(self) -> List[str]:
        return [m for m in self.sent if isinstance(m, str)]

    def n_frames(self) -> int:
        return len(self.binary())

    # -- async iteration (ws_handler's `async for message in websocket`) ---

    def __aiter__(self) -> "InProcessClient":
        return self

    async def __anext__(self):
        m = await self._incoming.get()
        if m is None:
            raise StopAsyncIteration
        return m

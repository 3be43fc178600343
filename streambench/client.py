"""The benchmark's client: one in-process websocket per display.

It stands where a browser tab stands: it sends ``SETTINGS`` for its
display, records the arrival time of every message the server sends it,
and ACKs every frame on arrival (``CLIENT_FRAME_ACK <id>``). Traffic
crosses no network: ``ws_handler`` awaits this object's ``send`` and
iterates it for client messages.

A frame is complete when its last stripe has arrived. The server queues
every stripe of a frame at once and its send queue hands them over in one
burst without yielding to the event loop, so an ACK scheduled with
``call_soon`` at the first stripe runs after the frame's last stripe has
arrived (and after the server registered the frame for its ACK). The
frame's receipt time is its last stripe's arrival.
"""

from __future__ import annotations

import asyncio
import json
import struct
import time
from typing import Dict, List, Optional, Tuple

#: server -> client binary types that carry video: JPEG stripes, H.264
#: stripes, H.264 full frames
VIDEO_TYPES = (0x03, 0x04, 0x00)
_U16 = struct.Struct(">H")


class Frame:
    """One delivered frame of one epoch of a display."""

    __slots__ = ("display", "epoch", "frame_id", "t_first", "t_last",
                 "messages")

    def __init__(self, display: str, epoch: int, frame_id: int,
                 t: float) -> None:
        self.display = display
        self.epoch = epoch
        self.frame_id = frame_id
        self.t_first = t
        self.t_last = t
        self.messages: List[bytes] = []


class BenchClient:
    """Just enough websocket surface for ``ws_handler``: async ``send``,
    ``close``, async iteration."""

    def __init__(self, display: str, width: int, height: int,
                 framerate: int) -> None:
        self.display = display
        self.closed = False
        #: frames whose first stripe arrives from this monotonic time on
        #: keep their messages (the window's frames, for the comparison)
        self.keep_from = float("inf")
        self._incoming: asyncio.Queue = asyncio.Queue()
        self.epoch = 0
        #: (epoch, frame id) -> Frame, in arrival order
        self.frames: Dict[Tuple[int, int], Frame] = {}
        self.texts: List[Tuple[float, str]] = []
        self._unacked: List[int] = []
        self._ack_scheduled = False
        self.feed("SETTINGS," + json.dumps({
            "displayId": display, "initialClientWidth": width,
            "initialClientHeight": height, "framerate": framerate}))

    # -- server -> client --------------------------------------------------

    async def send(self, message) -> None:
        if self.closed:
            raise ConnectionError("closed")
        self._arrive(message)

    def send_nowait(self, message) -> None:
        if not self.closed:
            self._arrive(message)

    def _arrive(self, message) -> None:
        t = time.monotonic()
        if isinstance(message, str):
            self.texts.append((t, message))
            if message.startswith("PIPELINE_RESETTING"):
                self.epoch += 1
            return
        data = bytes(message)
        if not data or data[0] not in VIDEO_TYPES:
            return
        fid = _U16.unpack_from(data, 2)[0]
        key = (self.epoch, fid)
        fr = self.frames.get(key)
        if fr is None:
            fr = self.frames[key] = Frame(self.display, self.epoch, fid, t)
            self._unacked.append(fid)
            if not self._ack_scheduled:
                self._ack_scheduled = True
                asyncio.get_running_loop().call_soon(self._ack)
        fr.t_last = t
        if fr.t_first >= self.keep_from:
            fr.messages.append(data)

    def _ack(self) -> None:
        self._ack_scheduled = False
        for fid in self._unacked:
            self.feed(f"CLIENT_FRAME_ACK {fid}")
        self._unacked.clear()

    # -- client -> server --------------------------------------------------

    def feed(self, message: Optional[str]) -> None:
        self._incoming.put_nowait(message)

    async def close(self) -> None:
        if not self.closed:
            self.closed = True
            self._incoming.put_nowait(None)

    def __aiter__(self) -> "BenchClient":
        return self

    async def __anext__(self):
        m = await self._incoming.get()
        if m is None:
            raise StopAsyncIteration
        return m

    # -- reading -------------------------------------------------------------

    def killed(self) -> Optional[str]:
        for _t, m in self.texts:
            if m.startswith("KILL"):
                return m
        return None

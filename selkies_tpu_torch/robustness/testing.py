"""In-process stand-ins for driving the data server without sockets or a
card (the port's copy of ``selkies_tpu/robustness/testing.py``).

``data_server._ws_broadcast`` duck-types on ``send_nowait``, and
``ws_handler`` only needs async ``send``/``close`` plus async iteration —
so :class:`InProcessClient` is a full client as far as the server is
concerned. The port's server tests and ``chip_smoke.py`` drive the server
with it.

:class:`FakeMeshEncoder` is the device-free counterpart on the encoder
side: it speaks the lane-encoder surface the coordinator drives
(``dispatch``/``harvest``/``fetch_ready``/``reset_session``/
``force_keyframe``), so the scheduler — dynamic lanes, slot health,
quarantine and migration, churn — is testable without a device step.
"""

from __future__ import annotations

import asyncio
from dataclasses import dataclass
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


# ---------------------------------------------------------------------------
# mesh-encoder stand-in (scheduler tests / swarm harness)


@dataclass
class FakeStripe:
    """Just enough stripe surface for the wire packer (no ``annexb``
    attribute → packs as a JPEG stripe)."""

    y_start: int = 0
    height: int = 16
    jpeg: bytes = b"\xff\xd8\xfa\x4b\x45\xff\xd9"
    is_paintover: bool = False


class FakeMeshEncoder:
    """Mesh-encoder lookalike: one tiny stripe per submitted session
    (``n_shards`` of them for an SFE-shaped lane — the torn-access-unit
    tests assert a harvested frame always carries ALL of its shard
    stripes or none).

    ``fail_dispatches`` fails that many whole dispatch calls (a lane-level
    fault); slot-scoped faults are injected upstream of dispatch via the
    coordinator's ``mesh.slot_raise`` point, not here. Harvests report a
    ``last_harvest_stages`` fetch/concat split like the real mesh
    encoders so the coordinator's flight-recorder attribution is
    exercised device-free.
    """

    def __init__(self, n_sessions: int, width: int = 0, height: int = 0,
                 fail_dispatches: int = 0, n_shards: int = 1) -> None:
        self.n_sessions = int(n_sessions)
        self.width, self.height = width, height
        self.fail_dispatches = int(fail_dispatches)
        self.n_shards = max(1, int(n_shards))
        self.dispatches = 0
        self.resets: List[int] = []
        self.keyframes: List[int] = []
        self.last_harvest_stages = None
        #: tests add session indices here to model encoder-INTERNAL
        #: stripe-job failures (whole-frame containment: harvest returns
        #: an empty AU for them, nothing raises) — reported through
        #: last_failed_sessions so the coordinator charges slot health
        self.fail_sessions: set = set()
        self.last_failed_sessions: frozenset = frozenset()

    def reset_session(self, session: int) -> None:
        self.resets.append(session)

    def force_keyframe(self, session: int) -> None:
        self.keyframes.append(session)

    def dispatch(self, frames):
        if self.fail_dispatches > 0:
            self.fail_dispatches -= 1
            raise RuntimeError("injected mesh dispatch failure")
        self.dispatches += 1
        return [f is not None for f in frames]

    def fetch_ready(self, pending) -> bool:
        return True

    def harvest(self, pending):
        out = [
            [FakeStripe(y_start=16 * k, height=16)
             for k in range(self.n_shards)] if took else []
            for took in pending]
        failed = {n for n, took in enumerate(pending)
                  if took and n in self.fail_sessions}
        for n in failed:
            out[n] = []                      # withheld whole, never torn
        self.last_failed_sessions = frozenset(failed)
        session_bytes = [sum(len(st.jpeg) for st in s) for s in out]
        self.last_harvest_stages = {
            "fetch_ms": 0.2, "concat_ms": 0.1,
            "per_shard_fetch_ms": [0.2 / self.n_shards] * self.n_shards}
        return out, session_bytes

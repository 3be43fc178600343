"""Deterministic fault injection for the capture→encode→transport path
(the port's copy of ``selkies_tpu/robustness/faults.py``).

The supervision layer (``supervisor.py``, ``ladder.py``) only earns trust if
its recovery behavior is *provable*: tests must be able to crash a
capture loop, stall a fetch, or drop a websocket on demand and then assert
restart counts and ladder transitions. This module provides named fault
points that are checked at the real call sites
(``server/data_server._capture_loop``, the async driver's harvest and
the lane scheduler's tick),
armed either programmatically or from the ``SELKIES_TPU_FAULTS``
environment variable / ``tpu_faults`` setting. One spec string means the
same to this server and to the JAX package's.

Grammar (comma-separated entries)::

    SELKIES_TPU_FAULTS="capture.raise*2,fetch.hang*1=30,ws.drop"

    entry   := point ['*' count] ['=' arg]
    point   := dotted fault-point name (see POINTS)
    count   := how many checks fire before the point disarms (default: 1)
    arg     := point-specific parameter (hang points: seconds, default 3600)

Fault points and their semantics at the call site:

==================  =======================================================
``capture.raise``   capture loop raises at the top of its tick
``capture.stall``   capture loop hangs (await) before reading the source —
                    no frame progress, so the watchdog must trip
``encode.raise``    the encoder submit call site raises (models a device /
                    entropy failure; classified as an EncoderFault, which
                    steps the degradation ladder)
``fetch.hang``      the poll/fetch call site hangs — stalled D2H transfer
``ws.drop``         the display's websocket is closed mid-stream
``mesh.tick_raise`` the mesh coordinator's whole tick raises (every lane
                    skips this tick; the worker backs off and survives)
``mesh.slot_raise`` ONE slot's dispatch is failed at frame-take time
                    (arg: ``lane:slot`` or a bare slot index; empty =
                    first checked slot) — the cohabiting sessions' tick
                    proceeds, so chaos can prove slot faults never
                    become mesh faults
==================  =======================================================

The two ``mesh.*`` points are checked by the lane scheduler
(``parallel/coordinator.py``): ``mesh.tick_raise`` at the top of its tick,
``mesh.slot_raise`` where a slot's frame is taken into a lane's batch.

A check on a disarmed point is a dict lookup — the production cost of the
harness is negligible, and a server with no faults armed never allocates.
"""

from __future__ import annotations

import asyncio
import logging
import re
import threading
from typing import Dict, Optional, Tuple

logger = logging.getLogger("selkies_tpu_torch.robustness")

#: the known fault points; arming an unknown name is an error so a typo in a
#: chaos spec fails loudly instead of silently never firing
POINTS = (
    "capture.raise",
    "capture.stall",
    "encode.raise",
    "fetch.hang",
    "ws.drop",
    "mesh.tick_raise",
    "mesh.slot_raise",
)

_ENTRY_RE = re.compile(
    r"^(?P<name>[a-z0-9_.]+)(?:\*(?P<count>\d+))?(?:=(?P<arg>.+))?$")

#: default hang duration — long enough that only a watchdog ends it
DEFAULT_HANG_S = 3600.0


class FaultInjected(RuntimeError):
    """Raised by a ``*.raise`` fault point."""

    def __init__(self, point: str) -> None:
        super().__init__(f"injected fault: {point}")
        self.point = point


class FaultInjector:
    """Thread-safe registry of armed fault points.

    One injector per :class:`~selkies_tpu_torch.server.data_server.DataStreamingServer`
    (constructed from ``settings.tpu_faults``) keeps tests isolated; tools
    arm points on a live server via ``server.faults.arm(...)``.
    """

    def __init__(self, spec: str = "") -> None:
        self._lock = threading.Lock()
        #: point -> (remaining_count, arg)
        self._armed: Dict[str, Tuple[int, Optional[str]]] = {}
        #: point -> times fired (monotonic, survives disarm; test assertions)
        self.fired: Dict[str, int] = {}
        if spec:
            self.arm_spec(spec)

    # -- arming ------------------------------------------------------------

    def arm_spec(self, spec: str) -> None:
        """Arm every entry of a ``SELKIES_TPU_FAULTS``-grammar string."""
        for entry in str(spec).split(","):
            entry = entry.strip()
            if not entry:
                continue
            m = _ENTRY_RE.match(entry)
            if not m:
                raise ValueError(f"bad fault spec entry {entry!r}")
            count = int(m.group("count")) if m.group("count") else 1
            self.arm(m.group("name"), times=count, arg=m.group("arg"))

    def arm(self, point: str, times: int = 1,
            arg: Optional[str] = None) -> None:
        if point not in POINTS:
            raise ValueError(
                f"unknown fault point {point!r}; known: {list(POINTS)}")
        with self._lock:
            self._armed[point] = (max(1, int(times)), arg)
        logger.warning("fault point armed: %s (times=%d, arg=%r)",
                       point, times, arg)

    def disarm(self, point: Optional[str] = None) -> None:
        with self._lock:
            if point is None:
                self._armed.clear()
            else:
                self._armed.pop(point, None)

    def reset(self) -> None:
        """Disarm everything and clear fire counters (test teardown)."""
        with self._lock:
            self._armed.clear()
            self.fired.clear()

    @property
    def armed(self) -> Tuple[str, ...]:
        with self._lock:
            return tuple(self._armed)

    # -- call-site checks --------------------------------------------------

    def should_fire(self, point: str) -> bool:
        """Consume one firing of ``point`` if armed (decrements the count)."""
        arg_unused, fired = self._take(point)
        return fired

    def should_fire_for(self, point: str, *keys) -> bool:
        """Consume one firing only when the armed arg targets one of
        ``keys`` (a call site may answer to several identities — e.g. a
        mesh slot is both ``lane:slot`` and its bare slot index).

        A keyed fault point (``mesh.slot_raise=0:3``) fires only at the
        call site checking that key; an argless arming fires for the
        first site checked. A non-matching check leaves the point armed —
        it neither fires nor consumes."""
        with self._lock:
            entry = self._armed.get(point)
            if entry is None:
                return False
            remaining, arg = entry
            if arg is not None and str(arg) not in {str(k) for k in keys}:
                return False
            if remaining <= 1:
                self._armed.pop(point, None)
            else:
                self._armed[point] = (remaining - 1, arg)
            self.fired[point] = self.fired.get(point, 0) + 1
        logger.warning("fault point fired: %s (keys=%s, #%d)", point, keys,
                       self.fired[point])
        return True

    def maybe_raise(self, point: str) -> None:
        """Raise :class:`FaultInjected` if ``point`` is armed."""
        _, fired = self._take(point)
        if fired:
            raise FaultInjected(point)

    async def maybe_hang(self, point: str) -> None:
        """Hang (cancellable await) if ``point`` is armed; the arg is the
        hang duration in seconds (default: effectively forever)."""
        arg, fired = self._take(point)
        if fired:
            duration = self._hang_duration(point, arg)
            await asyncio.sleep(duration)

    def maybe_hang_sync(self, point: str) -> None:
        """Thread-context counterpart of :meth:`maybe_hang` for call
        sites that run off the event loop (the async encode driver's
        fetch/harvest site): a plain blocking sleep, so chaos can stall
        the driver thread exactly where a wedged D2H transfer would."""
        arg, fired = self._take(point)
        if fired:
            import time

            duration = self._hang_duration(point, arg)
            time.sleep(duration)

    @staticmethod
    def _hang_duration(point: str, arg: Optional[str]) -> float:
        try:
            duration = float(arg) if arg else DEFAULT_HANG_S
        except ValueError:
            duration = DEFAULT_HANG_S
        logger.warning("fault %s: hanging %.1fs", point, duration)
        return duration

    def _take(self, point: str) -> Tuple[Optional[str], bool]:
        with self._lock:
            entry = self._armed.get(point)
            if entry is None:
                return None, False
            remaining, arg = entry
            if remaining <= 1:
                self._armed.pop(point, None)
            else:
                self._armed[point] = (remaining - 1, arg)
            self.fired[point] = self.fired.get(point, 0) + 1
        logger.warning("fault point fired: %s (#%d)", point,
                       self.fired[point])
        return arg, True

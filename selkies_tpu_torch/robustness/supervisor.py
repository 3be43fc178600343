"""Async task supervision: bounded-backoff restarts plus a frame watchdog
(the port's copy of ``selkies_tpu/robustness/supervisor.py``).

The reference desktop stack keeps a session alive across encoder hiccups and
capture stalls (SURVEY §0); here the equivalent is a :class:`Supervisor`
wrapped around each display's capture and backpressure loops: a crash
restarts the loop with exponential backoff and jitter, a restart budget over
a sliding window turns a crash loop into a terminal ``failed`` state instead
of a log-spamming hot loop, and an optional frame-deadline watchdog cancels
and restarts a child that stops making progress (stalled capture or D2H
fetch) even though it never raised.

The supervised coroutine calls :meth:`Supervisor.beat` whenever it makes
progress; everything else is driven by :meth:`run`, which is itself the
asyncio task the owner creates/cancels.
"""

from __future__ import annotations

import asyncio
import logging
import random
import time
from typing import Any, Callable, Coroutine, Dict, List, Optional

logger = logging.getLogger("selkies_tpu_torch.robustness")

#: supervisor lifecycle states
IDLE, RUNNING, BACKOFF, FAILED, STOPPED = (
    "idle", "running", "backoff", "failed", "stopped")


def backoff_delay(attempt: int, base_s: float, cap_s: float,
                  jitter: float = 0.0,
                  rng: Optional[random.Random] = None) -> float:
    """Capped exponential backoff: ``min(cap, base * 2**(attempt-1))``
    scaled by ``1 + jitter*rand()``. The one formula for every retry site
    (supervisor restarts, server bind retries, mesh tick backoff)."""
    attempt = max(1, int(attempt))
    delay = min(cap_s, base_s * (2 ** min(attempt - 1, 32)))
    if jitter:
        delay *= 1.0 + jitter * (rng or random).random()
    return delay


class Supervisor:
    """Restart an async task factory until cancelled, failed, or stopped.

    Restart policy
    --------------
    * child raised → restart after ``min(max_delay, base_delay * 2**n)``
      scaled by ``1 + jitter*rand()``, where n counts recent failures;
    * watchdog tripped (no :meth:`beat` within ``watchdog_timeout_s``) →
      child is cancelled and restarted like a failure;
    * child returned cleanly → restart after ``base_delay`` without
      counting against the budget (the capture loop returns cleanly on a
      deliberate reconfigure, e.g. a degradation-ladder rung change);
    * more than ``max_restarts`` failure/watchdog restarts within
      ``restart_window_s`` → terminal :data:`FAILED` state.

    ``on_event(kind, info)`` fires with kinds ``"failure"`` (info: the
    exception), ``"watchdog"``, ``"clean"``, ``"restart"``, ``"failed"`` —
    the owner uses it for metrics, the degradation ladder, and health
    broadcasts. Callback errors are logged, never propagated.
    """

    def __init__(
        self,
        name: str,
        factory: Callable[[], Coroutine],
        *,
        max_restarts: int = 6,
        restart_window_s: float = 60.0,
        base_delay_s: float = 0.05,
        max_delay_s: float = 2.0,
        jitter: float = 0.25,
        watchdog_timeout_s: Optional[float] = None,
        on_event: Optional[Callable[[str, Any], None]] = None,
        clock: Callable[[], float] = time.monotonic,
        rng: Optional[random.Random] = None,
    ) -> None:
        self.name = name
        self.factory = factory
        self.max_restarts = int(max_restarts)
        self.restart_window_s = float(restart_window_s)
        self.base_delay_s = float(base_delay_s)
        self.max_delay_s = float(max_delay_s)
        self.jitter = float(jitter)
        self.watchdog_timeout_s = watchdog_timeout_s
        self.on_event = on_event
        self._clock = clock
        self._rng = rng or random.Random()

        self.state = IDLE
        self.restarts_total = 0
        self.failures_total = 0
        self.watchdog_restarts_total = 0
        self.clean_restarts_total = 0
        self.last_error: Optional[str] = None
        self._beat = clock()
        self._failure_times: List[float] = []

    # -- progress heartbeat ------------------------------------------------

    def beat(self) -> None:
        """Mark progress; the watchdog measures staleness against this."""
        self._beat = self._clock()

    def forgive(self) -> None:
        """Clear the failure budget.

        The owner calls this when it took a corrective action in response
        to a failure (e.g. a degradation-ladder step-down): subsequent
        failures should be judged against the NEW configuration, not
        accumulate on top of the dead one — otherwise ladder probe cycles
        burn the budget and terminally fail a display whose degraded rung
        is perfectly healthy."""
        self._failure_times.clear()

    # -- main loop ---------------------------------------------------------

    async def run(self) -> None:
        """Supervise until cancelled (→ ``stopped``) or failed."""
        try:
            while True:
                self._set_state(RUNNING)
                self.beat()
                child = asyncio.ensure_future(self.factory())
                failure: Optional[BaseException] = None
                watchdog = False
                try:
                    failure, watchdog = await self._await_child(child)
                except asyncio.CancelledError:
                    await self._kill(child)
                    self._set_state(STOPPED)
                    raise
                counted = watchdog or failure is not None
                now = self._clock()
                if counted:
                    # charge the budget BEFORE emitting, so an on_event
                    # forgive() (ladder step-down) clears THIS failure too
                    # and the new configuration truly starts fresh
                    self._failure_times = [
                        t for t in self._failure_times
                        if now - t < self.restart_window_s]
                    self._failure_times.append(now)
                if watchdog:
                    self.watchdog_restarts_total += 1
                    self.last_error = "watchdog: no frame progress within " \
                        f"{self.watchdog_timeout_s:.2f}s"
                    logger.warning("[%s] %s; restarting", self.name,
                                   self.last_error)
                    self._emit("watchdog", None)
                elif failure is not None:
                    self.failures_total += 1
                    self.last_error = repr(failure)
                    logger.error("[%s] supervised task crashed: %r",
                                 self.name, failure)
                    self._emit("failure", failure)
                else:
                    self.clean_restarts_total += 1
                    self._emit("clean", None)

                if counted:
                    if len(self._failure_times) > self.max_restarts:
                        self._set_state(FAILED)
                        logger.error(
                            "[%s] restart budget exhausted (%d within "
                            "%.0fs); giving up", self.name,
                            len(self._failure_times), self.restart_window_s)
                        self._emit("failed", None)
                        return
                    delay = backoff_delay(
                        len(self._failure_times), self.base_delay_s,
                        self.max_delay_s, self.jitter, self._rng)
                else:
                    delay = self.base_delay_s
                self.restarts_total += 1
                self._emit("restart", None)
                self._set_state(BACKOFF)
                await asyncio.sleep(delay)
        except asyncio.CancelledError:
            self._set_state(STOPPED)
            raise

    async def _await_child(self, child: asyncio.Task):
        """Wait for the child to finish, policing the watchdog deadline.
        Returns (failure_exception_or_None, watchdog_tripped)."""
        while True:
            timeout = None
            if self.watchdog_timeout_s is not None:
                timeout = max(0.05, self.watchdog_timeout_s / 4.0)
            done, _ = await asyncio.wait({child}, timeout=timeout)
            if done:
                if child.cancelled():
                    # someone cancelled the child directly; treat like a
                    # clean return — the owner is reconfiguring
                    return None, False
                return child.exception(), False
            if (self.watchdog_timeout_s is not None
                    and self._clock() - self._beat > self.watchdog_timeout_s):
                await self._kill(child)
                return None, True

    @staticmethod
    async def _kill(child: asyncio.Task) -> None:
        child.cancel()
        await asyncio.gather(child, return_exceptions=True)

    # -- bookkeeping -------------------------------------------------------

    def _set_state(self, state: str) -> None:
        if state != self.state:
            self.state = state

    def _emit(self, kind: str, info: Any) -> None:
        if self.on_event is None:
            return
        try:
            self.on_event(kind, info)
        except Exception:
            logger.exception("[%s] on_event(%s) callback failed",
                             self.name, kind)

    def stats(self) -> Dict:
        return {
            "name": self.name,
            "state": self.state,
            "restarts_total": self.restarts_total,
            "failures_total": self.failures_total,
            "watchdog_restarts_total": self.watchdog_restarts_total,
            "clean_restarts_total": self.clean_restarts_total,
            "last_error": self.last_error,
        }

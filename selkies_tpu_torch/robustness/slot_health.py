"""Per-slot fault domains for the mesh session scheduler.

A batch lane (``parallel/coordinator.py``) packs several sessions into one
SPMD dispatch, which makes the *slot* — one session's position in the
batch — the natural fault domain: a slot that keeps surfacing errors
(failed dispatch/harvest ticks attributed to it, injected slot faults)
poisons every tick it rides, so the scheduler must stop trusting it and
move its session somewhere healthy. This module is the pure policy half:
error/latency EWMAs per slot, a sickness verdict, and the quarantine set.
The coordinator owns the mechanism (live migration, lane recycling).

Clock-injected and lock-free by design: the coordinator calls it under
its own lock, and tests drive it with a fake clock (the same discipline
as :mod:`.ratelimit`).

Decay model: the error score is a leaky accumulator with half-life
``window_s`` — ``record_error`` adds 1, and the score halves every
window. ``sick_errors`` is therefore "roughly this many errors within
the recent window", not a lifetime count: a slot that faulted a lot last
minute but is clean now converges back to healthy instead of being
condemned by history. Quarantine, by contrast, is sticky for the life of
the lane: once a slot is quarantined it never returns to the free list —
the lane itself is retired (and rebuilt on demand) once it drains, which
is how a chronically sick fault domain gets recycled.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Set

__all__ = ["SlotHealth"]


class SlotHealth:
    """Error/latency EWMAs and quarantine verdicts for one lane's slots."""

    def __init__(
        self,
        n_slots: int,
        *,
        sick_errors: float = 3.0,
        window_s: float = 30.0,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self.n_slots = int(n_slots)
        self.sick_errors = max(0.5, float(sick_errors))
        self.window_s = max(0.1, float(window_s))
        self._clock = clock
        now = clock()
        #: decayed error score per slot (≈ errors within the last window)
        self._score: List[float] = [0.0] * n_slots
        self._score_at: List[float] = [now] * n_slots
        #: EWMA of per-tick harvest latency attributed to this slot (ms);
        #: observability only — latency does not feed the sickness verdict
        #: (a slow lane is a capacity problem, not a fault domain)
        self.latency_ewma_ms: List[float] = [0.0] * n_slots
        #: lifetime error count per slot (monotonic; health feed / tests)
        self.errors_total: List[int] = [0] * n_slots
        #: slots removed from service for the life of the lane
        self.quarantined: Set[int] = set()

    # -- recording ---------------------------------------------------------

    def _decayed(self, slot: int) -> float:
        now = self._clock()
        dt = now - self._score_at[slot]
        if dt > 0:
            self._score[slot] *= 0.5 ** (dt / self.window_s)
            self._score_at[slot] = now
        return self._score[slot]

    def record_error(self, slot: int) -> None:
        self._decayed(slot)
        self._score[slot] += 1.0
        self.errors_total[slot] += 1

    def record_ok(self, slot: int, latency_ms: float = 0.0) -> None:
        self._decayed(slot)
        if latency_ms > 0.0:
            prev = self.latency_ewma_ms[slot]
            self.latency_ewma_ms[slot] = (
                latency_ms if prev == 0.0 else 0.8 * prev + 0.2 * latency_ms)

    # -- verdicts ----------------------------------------------------------

    def score(self, slot: int) -> float:
        return self._decayed(slot)

    def is_sick(self, slot: int) -> bool:
        """True when the slot's recent error mass crossed the threshold
        (quarantined slots are no longer *sick* — they are out of
        service, which is a different answer)."""
        return (slot not in self.quarantined
                and self._decayed(slot) >= self.sick_errors)

    def quarantine(self, slot: int) -> None:
        self.quarantined.add(slot)

    # -- export ------------------------------------------------------------

    def state(self) -> Dict[str, object]:
        """Health snapshot for the ``system_health`` feed / stats()."""
        return {
            "scores": [round(self._decayed(s), 2)
                       for s in range(self.n_slots)],
            "latency_ewma_ms": [round(v, 2) for v in self.latency_ewma_ms],
            "errors_total": list(self.errors_total),
            "quarantined": sorted(self.quarantined),
        }

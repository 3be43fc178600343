"""Graceful-degradation ladder for the encoder path (the port's copy of
``selkies_tpu/robustness/ladder.py``).

The encode pipeline has three operating points with strictly decreasing
device dependence; every one of them runs its kernels on the card:

  rung 0  ``device``  entropy coding on the card; D2H is the bitstream
  rung 1  ``host``    transform/quant (and, for H.264, the motion kernel)
                      on the card, entropy coding on the host
  rung 2  ``jpeg``    JPEG profile with host entropy (the DCT kernel on
                      the card) — the paint-over
                      fallback of last resort (reference parity: the
                      jpeg paint-over path that keeps a session usable
                      when the main encoder misbehaves)

Repeated encoder failures (``EncoderFault``, counted consecutively) step the
ladder DOWN one rung; a clean probe window at a degraded rung steps it back
UP one rung.  The ladder itself is a passive state machine — the capture
loop reads :attr:`rung` when (re)building its encoder and returns cleanly
when the rung changed under it, so every transition takes effect as an
encoder rebuild on the next supervised restart.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List


#: rung order, most capable first; index == degradation level
RUNGS = ("device", "host", "jpeg")


class EncoderFault(RuntimeError):
    """An encoder-path failure (device dispatch, fetch, entropy coding).

    The capture loop wraps exceptions from encoder submit/poll call sites in
    this type so the supervisor can distinguish "the encoder is sick" (step
    the ladder) from "the capture source hiccuped" (just restart).

    ``force_step`` marks overwhelming single-shot evidence (a wedged
    pipeline detected after a long no-progress window): the handler steps
    the ladder immediately via :meth:`DegradationLadder.force_step_down`
    instead of counting toward the consecutive threshold — which
    per-restart submit successes would otherwise keep resetting.
    """

    def __init__(self, message: str, *, force_step: bool = False) -> None:
        super().__init__(message)
        self.force_step = force_step


class DegradationLadder:
    """Consecutive-failure step-down, clean-probe step-up."""

    def __init__(self, fail_threshold: int = 3, probe_after_s: float = 15.0,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.fail_threshold = max(1, int(fail_threshold))
        self.probe_after_s = float(probe_after_s)
        self._clock = clock
        self._level = 0
        self._consecutive = 0
        self._last_change = clock()
        #: probe-up requires a window clean of ANY failure, not just a
        #: window since the transition — an intermittently failing tier
        #: must keep pushing the probe deadline out
        self._last_failure = clock()
        self.failures_total = 0
        #: transition log, e.g. ["device->host", "host->device"]
        self.transitions: List[str] = []

    @property
    def level(self) -> int:
        return self._level

    @property
    def rung(self) -> str:
        return RUNGS[self._level]

    @property
    def degraded(self) -> bool:
        return self._level > 0

    def record_failure(self) -> bool:
        """Count one encoder failure; True when the ladder stepped down."""
        self.failures_total += 1
        self._consecutive += 1
        self._last_failure = self._clock()
        if (self._consecutive >= self.fail_threshold
                and self._level < len(RUNGS) - 1):
            self._step(self._level + 1)
            return True
        return False

    def force_step_down(self) -> bool:
        """Immediate step-down on overwhelming single-shot evidence.

        A wedged pipeline detected after a long no-progress window IS the
        proof the current tier is sick — routing it through the
        consecutive-failure threshold would let the post-restart submit
        successes reset the count each cycle and the ladder would never
        move. True when a step happened (False at the bottom rung)."""
        self.failures_total += 1
        self._last_failure = self._clock()
        if self._level < len(RUNGS) - 1:
            self._step(self._level + 1)
            return True
        return False

    def record_success(self) -> bool:
        """Count clean progress; True when a probe stepped the ladder up.

        Success clears the consecutive-failure count.  At a degraded rung,
        ``probe_after_s`` of operation clean of BOTH transitions and
        failures is treated as a successful probe and the ladder recovers
        one rung (so a flapping device walks down again via the failure
        threshold, not instantly — hysteresis comes from the two windows).
        """
        self._consecutive = 0
        quiet_since = max(self._last_change, self._last_failure)
        if (self._level > 0
                and self._clock() - quiet_since >= self.probe_after_s):
            self._step(self._level - 1)
            return True
        return False

    def _step(self, level: int) -> None:
        self.transitions.append(f"{RUNGS[self._level]}->{RUNGS[level]}")
        self._level = level
        self._consecutive = 0
        self._last_change = self._clock()

    def state(self) -> Dict:
        return {
            "rung": self.rung,
            "level": self._level,
            "consecutive_failures": self._consecutive,
            "failures_total": self.failures_total,
            "transitions": list(self.transitions),
        }

"""Session robustness: supervision, graceful degradation, fault injection
(the port's copy of the parts of ``selkies_tpu/robustness/`` the port's
server runs).

* :class:`Supervisor` — bounded-backoff restarts with a restart budget and
  a frame-deadline watchdog, wrapped around each display's capture and
  backpressure loops;
* :class:`DegradationLadder` — device → host → jpeg encoder rungs, stepped
  down on repeated :class:`EncoderFault` and probed back up after a clean
  window; every rung runs its kernels on the card;
* :class:`FaultInjector` — named fault points checked at the real call
  sites, armed via ``SELKIES_TPU_FAULTS`` so tests prove recovery
  end-to-end instead of assuming it;
* :mod:`.ratelimit` — the wire edge's armor: :class:`TokenBucket` /
  :class:`ConnectionGuard` per-class rate limits and error budgets, and
  :class:`BoundedSendQueue` slow-consumer isolation, pure clock-injected
  policy the server wires to real connections;
* :class:`SlotHealth` — per-slot error EWMAs whose quarantine verdicts
  drive the lane scheduler's live migration (``parallel/coordinator.py``);
* :class:`InProcessClient` — the in-process websocket stand-in, and
  :class:`FakeMeshEncoder`/:class:`FakeStripe`, the device-free lane
  encoder the scheduler tests drive.
"""

from .faults import DEFAULT_HANG_S, POINTS, FaultInjected, FaultInjector
from .ladder import RUNGS, DegradationLadder, EncoderFault
from .ratelimit import (DEFAULT_LIMITS, MESSAGE_CLASSES, UPLOAD_VERB_COST,
                        BoundedSendQueue, ConnectionGuard, TokenBucket,
                        classify_verb, parse_limit_spec)
from .slot_health import SlotHealth
from .supervisor import (BACKOFF, FAILED, IDLE, RUNNING, STOPPED, Supervisor,
                         backoff_delay)
from .testing import FakeMeshEncoder, FakeStripe, InProcessClient

__all__ = [
    "BACKOFF", "BoundedSendQueue", "ConnectionGuard", "DEFAULT_HANG_S",
    "DEFAULT_LIMITS", "DegradationLadder", "EncoderFault", "FAILED",
    "FakeMeshEncoder", "FakeStripe", "FaultInjected", "FaultInjector",
    "IDLE", "InProcessClient", "MESSAGE_CLASSES", "POINTS", "RUNGS",
    "RUNNING", "STOPPED", "SlotHealth", "Supervisor", "TokenBucket",
    "UPLOAD_VERB_COST", "backoff_delay", "classify_verb",
    "parse_limit_spec",
]

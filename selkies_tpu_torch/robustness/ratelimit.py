"""Hostile-client armor for the wire edge: token buckets, error budgets,
and bounded send queues (the port's copy of
``selkies_tpu/robustness/ratelimit.py``).

Supervision keeps the *inside* of a session alive; this module hardens
the *edge*. Everything here is pure, clock-injected policy so it
unit-tests without asyncio or sockets; the server wires it to real
connections in ``server/data_server.py``:

* :class:`TokenBucket` — the standard refill-rate/burst limiter, used per
  connection and per message class;
* :class:`ConnectionGuard` — one per websocket: a bucket per message
  class plus a slow-refilling protocol-error budget whose exhaustion
  means "this client is hostile, close it";
* :class:`BoundedSendQueue` — per-client fan-out queue with
  drop-oldest-video / never-drop-control semantics and a sustained-
  overflow eviction verdict, so one stalled consumer costs itself, not
  the capture loop or its healthy co-viewers.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Callable, Deque, Dict, Optional, Tuple

__all__ = [
    "DEFAULT_LIMITS", "MESSAGE_CLASSES", "UPLOAD_VERB_COST",
    "BoundedSendQueue", "ConnectionGuard", "TokenBucket", "classify_verb",
    "parse_limit_spec",
]

#: message classes the edge meters independently. Units: messages/s for
#: the verb classes, bytes/s for the binary-plane classes.
MESSAGE_CLASSES = ("input", "control", "settings", "resize", "upload", "mic")

#: per-class (refill_per_s, burst) defaults. Rationale:
#:  input    mouse-move streams run 100-250 msg/s; 1000/s leaves honest
#:           clients untouched and caps a flood at ~1k handler calls/s
#:  control  CLIENT_FRAME_ACK arrives once per decoded frame (<=120/s)
#:  settings SETTINGS re-negotiation (and cmd) is a human-scale event;
#:           every accepted one can restart pipelines
#:  resize   resize observers fire in bursts while dragging; the debounced
#:           reconfigure absorbs the cost, this just bounds parse work
#:  upload   file chunks (bytes/s) — a saturated 500 Mb/s link
#:  mic      48 kHz stereo s16 PCM is ~192 KiB/s; 1 MiB/s is generous
DEFAULT_LIMITS: Dict[str, Tuple[float, float]] = {
    "input": (1000.0, 2000.0),
    "control": (300.0, 900.0),
    "settings": (1.0, 5.0),
    "resize": (10.0, 40.0),
    "upload": (64e6, 128e6),
    "mic": (1e6, 4e6),
}

#: client verbs that are cheap bookkeeping, not work triggers
_CONTROL_VERBS = frozenset({
    "CLIENT_FRAME_ACK", "_f", "_l",
    "SET_NATIVE_CURSOR_RENDERING",
})

#: stateful upload verbs: DROPPING one corrupts the transfer (a lost END
#: leaves the fd open and splices the next file into it), so like upload
#: bytes they are PACED through the upload bucket, never dropped
_UPLOAD_VERBS = frozenset({
    "FILE_UPLOAD_START", "FILE_UPLOAD_END", "FILE_UPLOAD_ERROR",
})

#: nominal byte charge per upload verb against the upload bucket — each
#: START is an open()/makedirs on the server, far heavier than a text
#: parse; 64 KiB bounds file-churn spam to ~rate/64Ki verbs per second
UPLOAD_VERB_COST = 64 * 1024

#: verbs that can (re)start pipelines or spawn processes — human-scale
#: only. START/STOP_VIDEO tear down / rebuild a capture+encode pipeline
#: and START/STOP_AUDIO toggle the shared audio pipeline, so they are as
#: heavy as a SETTINGS renegotiation, not cheap control traffic.
_SETTINGS_VERBS = frozenset({
    "SETTINGS", "cmd",
    "START_VIDEO", "STOP_VIDEO", "START_AUDIO", "STOP_AUDIO",
})

#: verbs that feed the (debounced) display-reconfigure path
_RESIZE_VERBS = frozenset({"r", "s"})


def classify_verb(verb: str) -> str:
    """Map a parsed client verb onto its rate-limit class; everything not
    otherwise classified is input-plane grammar (kd/ku/m/js/clipboard/…).
    The ``upload`` class is special at the call site: paced, not dropped."""
    if verb in _SETTINGS_VERBS:
        return "settings"
    if verb in _RESIZE_VERBS:
        return "resize"
    if verb in _CONTROL_VERBS:
        return "control"
    if verb in _UPLOAD_VERBS:
        return "upload"
    return "input"


def parse_limit_spec(spec: str) -> Dict[str, Tuple[float, float]]:
    """Parse the ``rate_limits`` setting: ``class=rate[:burst],...``
    overriding :data:`DEFAULT_LIMITS` (burst defaults to 2x rate).

    ``settings=2:10,mic=512000`` → settings 2/s burst 10, mic 512 KB/s
    burst 1 MB. Unknown classes raise so a typo fails loudly.
    """
    limits = dict(DEFAULT_LIMITS)
    for entry in str(spec or "").split(","):
        entry = entry.strip()
        if not entry:
            continue
        name, sep, rates = entry.partition("=")
        name = name.strip()
        if not sep or name not in limits:
            raise ValueError(
                f"bad rate_limits entry {entry!r}; classes: "
                f"{list(MESSAGE_CLASSES)}, grammar class=rate[:burst]")
        rate_s, _, burst_s = rates.partition(":")
        rate = float(rate_s)
        burst = float(burst_s) if burst_s else 2.0 * rate
        if rate <= 0 or burst <= 0:
            raise ValueError(f"rate_limits entry {entry!r} must be positive")
        limits[name] = (rate, burst)
    return limits


class TokenBucket:
    """Classic token bucket: ``burst`` capacity refilled at ``rate``/s."""

    def __init__(self, rate: float, burst: float,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.rate = float(rate)
        self.burst = float(burst)
        self._clock = clock
        self._tokens = self.burst
        self._at = clock()

    def _refill(self) -> None:
        now = self._clock()
        self._tokens = min(self.burst,
                           self._tokens + (now - self._at) * self.rate)
        self._at = now

    def try_take(self, n: float = 1.0) -> bool:
        """Consume ``n`` tokens if available; False means rate-limited."""
        self._refill()
        if self._tokens >= n:
            self._tokens -= n
            return True
        return False

    def take_with_debt(self, n: float = 1.0) -> float:
        """Always consume ``n`` (tokens may go negative) and return the
        seconds the caller should pace before reading more — the pacing
        variant for byte planes where dropping corrupts the stream
        (uploads): sleeping in the handler propagates straight into TCP
        backpressure on the sender."""
        self._refill()
        self._tokens -= n
        if self._tokens >= 0:
            return 0.0
        return -self._tokens / self.rate

    @property
    def tokens(self) -> float:
        """Current level (refreshes first; for tests/introspection)."""
        self._refill()
        return self._tokens


class ConnectionGuard:
    """Per-connection protocol armor: class buckets + an error budget.

    The error budget is itself a token bucket (capacity
    ``error_budget``, refilled at ``error_refill_per_s``) so a long-lived
    session forgives the occasional glitch while a malformed-message
    flood still exhausts it quickly. :meth:`record_error` returns True
    when the budget is exhausted — the caller should send
    ``KILL protocol_abuse`` and close that one socket.
    """

    def __init__(self, limits: Optional[Dict[str, Tuple[float, float]]] = None,
                 error_budget: int = 25, error_refill_per_s: float = 0.5,
                 clock: Callable[[], float] = time.monotonic) -> None:
        limits = limits or DEFAULT_LIMITS
        self._buckets = {
            cls: TokenBucket(rate, burst, clock=clock)
            for cls, (rate, burst) in limits.items()
        }
        self._errors = TokenBucket(error_refill_per_s,
                                   max(1.0, float(error_budget)), clock=clock)
        self.errors_total = 0

    def allow(self, cls: str, n: float = 1.0) -> bool:
        """Charge ``n`` units (messages or bytes) against ``cls``; False
        means the message should be dropped. Counting dropped messages is
        the caller's job (one accounting site: the server's edge stats +
        ``rate_limited_total{klass}``).

        ``n`` is clamped to the bucket's burst: the bucket meters *rate*,
        size gating belongs to the explicit caps (``max_mic_chunk_kb``,
        ``max_upload_mb``) — otherwise one unit larger than the burst
        could never be admitted at any send rate."""
        bucket = self._buckets.get(cls)
        return bucket is None or bucket.try_take(min(n, bucket.burst))

    def throttle(self, cls: str, n: float = 1.0,
                 max_wait_s: float = 30.0) -> float:
        """Pacing variant of :meth:`allow` for streams where dropping
        corrupts state (file uploads): always accepts, returns how long
        the caller should sleep before reading more (0.0 = no debt)."""
        bucket = self._buckets.get(cls)
        if bucket is None:
            return 0.0
        return min(max_wait_s, bucket.take_with_debt(n))

    def record_error(self) -> bool:
        """Count one protocol error; True → budget exhausted, kill."""
        self.errors_total += 1
        return not self._errors.try_take(1.0)


class BoundedSendQueue:
    """Per-client fan-out queue: drop-oldest-video, never-drop-control.

    Video (binary media) entries are bounded at ``max_video``; offering
    past the bound drops the *oldest* queued video message so a slow
    consumer always converges toward the live edge of the stream.
    Control (text) messages are never dropped — they are small, rare,
    and semantically load-bearing (KILL, PIPELINE_RESETTING, settings).

    Eviction verdict: the first drop of a saturated stretch stamps
    ``overflow_since``; draining back under half capacity clears it. A
    consumer saturated for ``evict_after_s`` (or whose control backlog
    exceeds 10x the video bound — it is not reading *anything*) should
    be evicted (:attr:`should_evict`).
    """

    def __init__(self, max_video: int = 120, evict_after_s: float = 4.0,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.max_video = max(1, int(max_video))
        self.evict_after_s = float(evict_after_s)
        self._clock = clock
        self._q: Deque[Tuple[object, bool]] = deque()
        self.video_len = 0
        self.dropped_video_total = 0
        self.overflow_since: Optional[float] = None
        #: optional hook called with each video message discarded by the
        #: drop-oldest policy — the flight recorder closes a dropped
        #: frame's span through it (never raises into the offer path)
        self.on_drop: Optional[Callable[[object], None]] = None

    def __len__(self) -> int:
        return len(self._q)

    def offer(self, message, control: bool = False) -> bool:
        """Enqueue; returns False when an old video message was dropped
        to make room (the new message itself is always queued)."""
        if control:
            self._q.append((message, True))
            return True
        dropped = False
        if self.video_len >= self.max_video:
            for i, (msg, ctl) in enumerate(self._q):
                if not ctl:
                    del self._q[i]
                    self.video_len -= 1
                    self.dropped_video_total += 1
                    dropped = True
                    if self.overflow_since is None:
                        self.overflow_since = self._clock()
                    if self.on_drop is not None:
                        try:
                            self.on_drop(msg)
                        except Exception:
                            pass
                    break
        self._q.append((message, False))
        self.video_len += 1
        return not dropped

    def pop(self):
        """Next message in FIFO order, or None when empty."""
        if not self._q:
            return None
        message, control = self._q.popleft()
        if not control:
            self.video_len -= 1
        if (self.overflow_since is not None
                and self.video_len <= self.max_video // 2):
            self.overflow_since = None   # consumer caught back up
        return message

    @property
    def should_evict(self) -> bool:
        if len(self._q) - self.video_len > 10 * self.max_video:
            return True
        return (self.overflow_since is not None
                and self._clock() - self.overflow_since >= self.evict_after_s)

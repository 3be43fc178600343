"""Frame flight recorder: per-stage tracing from capture to client ACK.

The port's copy of ``selkies_tpu/observability/tracing.py``; its one
change is the profiler hook, a ``torch.profiler`` capture
(:func:`capture_profiler_trace`) where the JAX package runs
``jax.profiler``.

The reference has no tracer (SURVEY §5 row 1: client-side FPS counting
only), so its end-to-end latency was never attributable — and neither
was ours: the async driver (docs/pipeline.md) hides the dispatch/fetch
round trip, but nothing proved *where* the remaining glass-to-glass
milliseconds lived. This module is the measurement substrate for that
question (ROADMAP item 1's "measured at the glass, not the chip"), and
the feedback channel items 2-3 (SFE, rate control) will read from.

Every served frame carries a :class:`FrameTrace` — a trace context of
(display/session id, wire frame id) threaded through the full path::

    capture -> stage -> dispatch -> fetch_wait -> pack -> queue -> send -> ack

Call sites mark stages with absolute monotonic intervals; the recorder
never reads the clock on the hot path. A span is *closed* exactly once,
with a terminal mark:

* ``acked``            — the client's CLIENT_FRAME_ACK landed (the ack
                         stage is true network RTT + client decode);
* ``empty``            — the frame encoded to zero emitted stripes
                         (damage gating; normal, not a loss);
* ``dropped@<stage>``  — the frame was lost at that stage (submit
                         backpressure, encoder error, send-queue
                         overflow, supervised restart, ...);
* ``expired@<stage>``  — no terminal event arrived within the expiry
                         window (e.g. a client that never ACKs).

Dropped and expired frames therefore NEVER leak an open span — the
open-span count is an invariant tools/chaos_run.py asserts to zero.

Concurrency: marks land from the event loop, the async-driver thread,
and mesh worker threads. The recorder is lock-free in the CPython
sense — the completed ring is a preallocated list written through a
single monotonically increasing index, and the open/awaiting tables are
plain dicts; every mutation is one GIL-atomic operation, so there are
no locks (and no possible lock-order inversions) anywhere on the frame
path.

Export surfaces:

* per-stage Prometheus histograms with a ``display`` label, plus
  ``glass_to_glass_ms`` / ``encode_only_ms`` (observability/metrics.py);
* Chrome trace-event JSON (Perfetto-loadable) of the last N seconds —
  served at ``/debug/trace`` and summarized by tools/trace_report.py;
* per-display stage summaries riding the ``system_health`` wire feed.

A lane frame's span carries the port's :data:`LANE_STAGES` besides
:data:`STAGES`: the waits between the recorder's stages, so that a lane
span's stages tile it from capture start to send end.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

__all__ = [
    "STAGES", "FlightRecorder", "FrameTrace",
]

#: the eight stages of a served frame's flight, in path order.
#:
#: capture     host wall time in ``source.next_frame()``
#: stage       H2D staging (donated ring copy / host batch stack)
#: dispatch    device program launch (not device compute)
#: fetch_wait  host time blocked materializing the D2H fetch
#: pack        host-side entropy glue / stripe assembly
#: queue       dwell in the owner's bounded send queue
#: send        transport send (websocket write)
#: ack         send completion -> CLIENT_FRAME_ACK (network RTT + decode)
STAGES = ("capture", "stage", "dispatch", "fetch_wait", "pack",
          "queue", "send", "ack")

#: the port's stages of a lane frame's flight (``parallel/coordinator.py``,
#: ``handoff`` in ``server/data_server.py``, which marks it on a solo
#: frame's span too), in path order. With capture, dispatch, fetch_wait,
#: pack, queue and send they tile a lane span from capture start to send
#: end; ``device`` overlaps dispatch.
#:
#: superseded   first submit of the slot's run of pending frames -> the
#:              submit of the frame the tick took (the newest: the lane
#:              encodes it into the run's first span)
#: pending      that submit -> the tick's dispatch start (planning, and a
#:              full in-flight window's blocking harvest)
#: device       the tick on the card, first shard's start -> last shard's
#:              completion, on the host clock (on a card only)
#: device_tail  dispatch end -> the tick's device completion where later,
#:              at most up to the harvest's start (on a card only)
#: harvest_lag  dispatch end (or device completion) -> harvest start
#: handoff      pack end -> the frame's last stripe offered to its send
#:              queue (the capture loop's poll, then the emit)
LANE_STAGES = ("superseded", "pending", "device", "device_tail",
               "harvest_lag", "handoff")


class FrameTrace:
    """One frame's flight: (display, wire frame id) + stage intervals.

    ``spans`` maps stage name to an absolute ``(start, end)`` monotonic
    interval. Stages may overlap or be missing (a mesh session folds
    pack into fetch_wait; a host-rung frame has no device dispatch) —
    consumers read durations per stage, never assume contiguity.
    """

    __slots__ = ("display", "frame_id", "t0", "spans", "terminal",
                 "_token")

    def __init__(self, display: str, t0: float) -> None:
        self.display = display
        self.frame_id: int = -1        # wire id; assigned at pack time
        self.t0 = t0                   # span open (capture start)
        self.spans: Dict[str, Tuple[float, float]] = {}
        self.terminal: Optional[str] = None
        self._token: int = 0

    def mark(self, stage: str, t_start: float, t_end: float) -> None:
        """Record one stage's absolute interval (idempotent per stage:
        a re-mark overwrites, keeping one interval per stage)."""
        self.spans[stage] = (t_start, t_end)

    def merge(self, intervals: Optional[Dict[str, Tuple[float, float]]]
              ) -> None:
        """Fold in the encoder-side intervals harvested with the frame
        (the pipelines report stage/dispatch/fetch_wait/pack)."""
        if intervals:
            self.spans.update(intervals)

    def duration_ms(self, stage: str) -> Optional[float]:
        iv = self.spans.get(stage)
        if iv is None:
            return None
        return (iv[1] - iv[0]) * 1000.0

    @property
    def t_end(self) -> float:
        """Latest marked instant (== close time for terminal spans)."""
        if not self.spans:
            return self.t0
        return max(iv[1] for iv in self.spans.values())

    @property
    def total_ms(self) -> float:
        """Open -> latest mark. For acked spans this is glass-to-glass."""
        return (self.t_end - self.t0) * 1000.0

    @property
    def encode_only_ms(self) -> Optional[float]:
        """Submit -> stripes host-packed: the ROADMAP item 1 criterion
        (compare against ``h264_device_ms_per_frame``). Elapsed wall
        between the first encoder-side stage start and the pack end —
        queueing inside the async driver counts, because the glass does
        not care which thread was slow."""
        starts = [self.spans[s][0] for s in ("stage", "dispatch")
                  if s in self.spans]
        end = self.spans.get("pack") or self.spans.get("fetch_wait")
        if not starts or end is None:
            return None
        return max(0.0, (end[1] - min(starts)) * 1000.0)

    @property
    def last_stage(self) -> str:
        """The stage whose interval ends latest ('open' when none)."""
        if not self.spans:
            return "open"
        return max(self.spans.items(), key=lambda kv: kv[1][1])[0]

    def as_dict(self) -> Dict[str, Any]:
        return {
            "display": self.display,
            "frame_id": self.frame_id,
            "terminal": self.terminal,
            "total_ms": round(self.total_ms, 3),
            "stages": {s: round((iv[1] - iv[0]) * 1000.0, 3)
                       for s, iv in self.spans.items()},
        }


def _pct(sorted_vals: List[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, int(len(sorted_vals) * q / 100.0))
    return sorted_vals[idx]


class FlightRecorder:
    """Ring-buffer recorder of frame flights + open-span accounting.

    * :meth:`begin` opens a span; every opened span MUST reach exactly
      one of :meth:`close` / :meth:`drop` / :meth:`expire` /
      :meth:`drop_awaiting` — :meth:`open_spans` is the leak detector.
    * :meth:`sent` registers the span for ACK correlation under its
      (display, wire frame id); :meth:`ack` closes it with the true
      network round trip.
    * Completed spans land in a fixed ring (single write index, no
      locks); :meth:`summary` and :meth:`export_trace_events` read a
      consistent-enough snapshot of it (a torn read can at worst miss
      or double-see one in-rotation frame — fine for percentiles).

    ``clock`` is injectable for deterministic tests; call sites that
    already measured their own intervals pass absolute times instead.
    """

    #: default seconds before an un-terminated span is expired
    EXPIRE_AFTER_S = 30.0

    def __init__(self, capacity: int = 4096, clock=time.monotonic) -> None:
        self.capacity = max(16, int(capacity))
        self._clock = clock
        self._ring: List[Optional[FrameTrace]] = [None] * self.capacity
        self._widx = 0
        self._next_token = 1
        #: token -> open trace (every span not yet terminal)
        self._open: Dict[int, FrameTrace] = {}
        #: (display, frame_id) -> trace awaiting CLIENT_FRAME_ACK
        self._awaiting: Dict[Tuple[str, int], FrameTrace] = {}
        self.metrics = None          # observability.Metrics, wired lazily
        # terminal accounting (cheap mirrors, assertable without prom)
        self.closed_total = 0
        self.dropped_total = 0
        self.expired_total = 0
        self.acked_total = 0
        #: epoch anchor so trace-event timestamps are wall-clock-ish
        self._epoch_mono = clock()
        self._epoch_wall = time.time()

    # -- span lifecycle ----------------------------------------------------

    def begin(self, display: str, t: Optional[float] = None) -> FrameTrace:
        tr = FrameTrace(display, self._clock() if t is None else t)
        token = self._next_token
        self._next_token = token + 1
        tr._token = token
        self._open[token] = tr
        return tr

    def open_spans(self) -> int:
        """Spans opened but not yet terminal (the leak invariant)."""
        return len(self._open)

    def _retire(self, tr: FrameTrace, terminal: str) -> None:
        """Single exit gate: detach from the open/awaiting tables, stamp
        the terminal mark, rotate into the ring, publish metrics."""
        if tr.terminal is not None:     # already closed (idempotent)
            return
        tr.terminal = terminal
        self._open.pop(tr._token, None)
        if tr.frame_id >= 0:
            cur = self._awaiting.get((tr.display, tr.frame_id))
            if cur is tr:
                self._awaiting.pop((tr.display, tr.frame_id), None)
        self._ring[self._widx % self.capacity] = tr
        self._widx += 1
        self.closed_total += 1
        self._publish(tr)

    def close(self, tr: FrameTrace, terminal: str = "acked") -> None:
        if terminal == "acked":
            self.acked_total += 1
        self._retire(tr, terminal)

    def drop(self, tr: FrameTrace, stage: str) -> None:
        """Terminal ``dropped@<stage>``: the frame was lost there."""
        self.dropped_total += 1
        self._retire(tr, f"dropped@{stage}")

    def finish_empty(self, tr: FrameTrace) -> None:
        """Damage gating emitted nothing: a normal coalesced frame, not
        a loss — closed so the span cannot leak, kept out of the drop
        counters and the glass-to-glass series."""
        self._retire(tr, "empty")

    # -- ACK correlation ---------------------------------------------------

    def sent(self, tr: FrameTrace) -> None:
        """The frame's last stripe left the transport: register under
        its wire id so the client's CLIENT_FRAME_ACK can close it. A
        wire-id collision (2^16 wrap with a stalled client) expires the
        stale span rather than leaking it."""
        if tr.terminal is not None or tr.frame_id < 0:
            return
        key = (tr.display, tr.frame_id)
        old = self._awaiting.get(key)
        if old is not None and old is not tr:
            self.expired_total += 1
            self._retire(old, f"expired@{old.last_stage}")
        self._awaiting[key] = tr

    def ack(self, display: str, frame_id: int,
            t: Optional[float] = None) -> Optional[FrameTrace]:
        """CLIENT_FRAME_ACK landed: close the span with the true network
        round trip (send end -> ack arrival)."""
        tr = self._awaiting.pop((display, int(frame_id)), None)
        if tr is None:
            return None
        now = self._clock() if t is None else t
        send_iv = tr.spans.get("send")
        t0 = send_iv[1] if send_iv else tr.t_end
        tr.mark("ack", t0, max(t0, now))
        self.close(tr, "acked")
        return tr

    # -- leak control ------------------------------------------------------

    def expire(self, older_than_s: Optional[float] = None) -> int:
        """Close every open span older than the window (clients that
        never ACK, abandoned in-flight work). Returns how many."""
        horizon = self._clock() - (self.EXPIRE_AFTER_S
                                   if older_than_s is None
                                   else older_than_s)
        stale = [tr for tr in list(self._open.values()) if tr.t0 <= horizon]
        for tr in stale:
            self.expired_total += 1
            self._retire(tr, f"expired@{tr.last_stage}")
        return len(stale)

    def drop_awaiting(self, display: str, stage: str = "reset") -> int:
        """Pipeline reset / display teardown: frames sent but not yet
        ACKed will never be — their ids restart at 1. Returns how many
        spans were closed."""
        stale = [tr for (d, _fid), tr in list(self._awaiting.items())
                 if d == display]
        for tr in stale:
            self.drop(tr, stage)
        return len(stale)

    # -- metrics -----------------------------------------------------------

    def _publish(self, tr: FrameTrace) -> None:
        m = self.metrics
        if m is None:
            return
        try:
            for stage, iv in tr.spans.items():
                m.observe_stage(tr.display, stage,
                                (iv[1] - iv[0]) * 1000.0)
            if tr.terminal == "acked":
                m.observe_glass_to_glass(tr.display, tr.total_ms)
            enc = tr.encode_only_ms
            if enc is not None and tr.terminal != "empty":
                m.observe_encode_only(tr.display, enc)
            if tr.terminal and tr.terminal.startswith(("dropped@",
                                                       "expired@")):
                m.inc_trace_dropped(tr.terminal.split("@", 1)[1])
            m.set_trace_open_spans(len(self._open))
        except Exception:       # metrics must never break the frame path
            pass

    # -- readers -----------------------------------------------------------

    def _completed(self, display: Optional[str] = None,
                   last_s: Optional[float] = None) -> List[FrameTrace]:
        horizon = None if last_s is None else self._clock() - last_s
        out = []
        for tr in list(self._ring):
            if tr is None:
                continue
            if display is not None and tr.display != display:
                continue
            if horizon is not None and tr.t_end < horizon:
                continue
            out.append(tr)
        return out

    def summary(self, display: Optional[str] = None,
                last_s: Optional[float] = None) -> Dict[str, Any]:
        """Per-stage p50/p95/p99 plus the two headline series, over the
        ring (optionally filtered by display / recency)."""
        traces = self._completed(display, last_s)
        stages: Dict[str, Any] = {}
        for stage in STAGES:
            vals = sorted(d for tr in traces
                          if (d := tr.duration_ms(stage)) is not None)
            if vals:
                stages[stage] = {
                    "p50_ms": round(_pct(vals, 50), 3),
                    "p95_ms": round(_pct(vals, 95), 3),
                    "p99_ms": round(_pct(vals, 99), 3),
                    "n": len(vals),
                }
        g2g = sorted(tr.total_ms for tr in traces
                     if tr.terminal == "acked")
        enc = sorted(e for tr in traces if tr.terminal != "empty"
                     and (e := tr.encode_only_ms) is not None)
        out: Dict[str, Any] = {
            "frames": len(traces),
            "acked": sum(1 for t in traces if t.terminal == "acked"),
            "dropped": sum(1 for t in traces if t.terminal
                           and t.terminal.startswith("dropped@")),
            "open_spans": len(self._open),
            "stages": stages,
        }
        if g2g:
            out["glass_to_glass_p50_ms"] = round(_pct(g2g, 50), 1)
            out["glass_to_glass_p95_ms"] = round(_pct(g2g, 95), 1)
        if enc:
            out["encode_only_p50_ms"] = round(_pct(enc, 50), 1)
            out["encode_only_p95_ms"] = round(_pct(enc, 95), 1)
        return out

    def slowest(self, k: int = 5, display: Optional[str] = None
                ) -> List[Dict[str, Any]]:
        """Top-k slowest completed frames with their stage timelines."""
        traces = sorted(self._completed(display),
                        key=lambda t: t.total_ms, reverse=True)
        return [tr.as_dict() for tr in traces[:max(0, int(k))]]

    # -- Chrome trace-event (Perfetto) export ------------------------------

    def export_trace_events(self, last_s: Optional[float] = None,
                            include_open: bool = False) -> Dict[str, Any]:
        """The last N seconds as Chrome trace-event JSON: load the
        result at https://ui.perfetto.dev (docs/observability.md has the
        walkthrough). One process per display, one thread row per frame
        (rows recycle mod a small constant so the view stays readable),
        one complete ("X") slice per stage."""
        events: List[Dict[str, Any]] = []
        pids: Dict[str, int] = {}
        traces = self._completed(None, last_s)
        if include_open:
            traces = traces + list(self._open.values())
        for tr in traces:
            pid = pids.setdefault(tr.display, len(pids) + 1)
            tid = (tr.frame_id if tr.frame_id >= 0 else tr._token) % 64 + 1
            for stage, iv in sorted(tr.spans.items(),
                                    key=lambda kv: kv[1][0]):
                events.append({
                    "name": stage,
                    "cat": "frame",
                    "ph": "X",
                    "pid": pid,
                    "tid": tid,
                    "ts": round((iv[0] - self._epoch_mono) * 1e6, 1),
                    "dur": round(max(0.0, iv[1] - iv[0]) * 1e6, 1),
                    "args": {
                        "frame_id": tr.frame_id,
                        "display": tr.display,
                        "terminal": tr.terminal or "open",
                        # unique per span: consumers regrouping events
                        # must not merge distinct frames that share a
                        # recycled tid and frame_id -1 (never-sent drops)
                        "span": tr._token,
                    },
                })
        for display, pid in pids.items():
            events.append({
                "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
                "args": {"name": f"display:{display}"},
            })
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {
                "recorder": "selkies-tpu flight recorder",
                "epoch_unix_s": round(self._epoch_wall, 3),
                "open_spans": len(self._open),
            },
        }


# ---------------------------------------------------------------------------
# torch.profiler capture hook (served at /debug/jax-trace, the JAX
# package's route name)


_PROFILER_TRACE_LOCK = threading.Lock()


def prepare_profiler_trace() -> None:
    """Start and stop ``torch.profiler``'s CUDA activity once in the
    calling thread. Its first start must run in the thread that registered
    the profiler's client (the process's main thread): started first from
    another thread (the HTTP server's), CUPTI records no device activity.
    No-op without a card."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if torch.cuda.is_available():
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            pass


def capture_profiler_trace(out_dir: str, duration_ms: float
                           ) -> Dict[str, Any]:
    """Run a ``torch.profiler`` capture (host and CUDA activity) for
    ``duration_ms`` (clamped to 10 ms .. 30 s) and write it into
    ``out_dir`` as Chrome trace-event JSON, so device-side stalls can be
    correlated with the host-side spans. Serialized (one capture at a
    time). On a host with a card it records the card's activity or
    raises: it never hands back a host-only profile in its place (the
    HTTP layer maps the error to an error response). CUPTI is
    process-wide, so a capture must not overlap another profiler use in
    the process."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    duration_s = min(30.0, max(0.01, float(duration_ms) / 1000.0))
    if not _PROFILER_TRACE_LOCK.acquire(blocking=False):
        raise RuntimeError("a profiler trace capture is already running")
    try:
        activities = [ProfilerActivity.CPU]
        on_card = torch.cuda.is_available()
        if on_card:
            if ProfilerActivity.CUDA not in \
                    torch.profiler.supported_activities():
                raise RuntimeError("torch.profiler cannot record CUDA "
                                   "activity (CUPTI unavailable)")
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as prof:
            time.sleep(duration_s)
        device_events = sum(
            1 for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA)
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, "trace.json")
        prof.export_chrome_trace(path)
    finally:
        _PROFILER_TRACE_LOCK.release()
    return {"path": path, "duration_ms": duration_s * 1000.0,
            "cuda": on_card, "device_events": device_events}

"""Pipelined encoders: overlap device steps, device-to-host copies and host
assembly (counterpart of ``selkies_tpu/encoder/pipeline.py``):
:class:`PipelinedJpegEncoder` for the JPEG-stripe profile and
:class:`PipelinedH264Encoder` (one or ``batch`` frames per dispatch) for
the H.264 profiles; and :class:`ThreadedEncoderAdapter`, which runs a
synchronous ``encode_frame`` (the host-entropy rungs) on a worker thread.

PyTorch launches asynchronously on a CUDA stream; the only blocking points
are host reads. This wrapper keeps several frames in flight: submit(frame
N) while harvesting frame N-depth. Where the JAX pipeline starts
``copy_to_host_async`` and polls ``is_ready``, this one starts a
``non_blocking`` copy into pinned host memory, records a CUDA event after
it on the encoder's stream, and polls ``Event.query()``. Every device call
runs on that one stream (``JpegStripeEncoder.stream``), whichever thread
makes it, so an event never reports a copy done before it is.

The step packs the per-frame metadata (sizes, stripe bases, overflow,
damage) into the head of the bitstream buffer, and the pipeline fetches
metadata + payload as ONE predicted-size read per frame (several frames
per read with ``fetch_group``); only a size-prediction miss costs a second
read. The prediction adapts to the recent largest frame plus headroom.

:class:`_Pipeline` holds what both profiles share: the in-flight queue,
staging tickets, grouped fetches, poll/flush/close and the telemetry. Each
profile adds its device step (``_start``), the prefix it fetches
(``_prefix``), how an item advances (``_advance``) and how it finishes
(``_finish``).

Frames come as host arrays, which ride a pinned staging ring, or as
tensors already on the encoder's device (``DeviceScrollSource``, a
capture that writes to the card), which skip it. Such a tensor was
written on its maker's stream: the encoders' ``adopt`` makes the encoder
stream wait for that stream and marks the tensor's memory in use there.
It is called once, in the thread that made the frame, by the public
entry point the frame leaves its caller through (``submit``,
``try_submit``, ``submit_batch``; the async driver's and the adapter's
``try_submit``/``submit``); the paths behind them take the tensor as it
is.

Flight recorder: each frame's stage intervals (absolute
``time.monotonic`` ``(start, end)`` pairs) ride its in-flight item and are
stored under its seq when it is harvested; the capture loop takes them
with :meth:`_Pipeline.pop_trace` and folds them into the frame's
:class:`~..observability.tracing.FrameTrace`:

* ``stage``: the host frame into the pinned staging ring and its upload
  queued (absent for a frame already on the card);
* ``dispatch``: the device step enqueued (host launch time, not device
  compute); the frames of one batched step share its ``stage`` and
  ``dispatch`` intervals;
* ``fetch_wait``: from the first harvest attempt of the frame's fetch
  group to the moment its bytes are on the host. The JAX pipeline blocks
  in the host read and stamps that; here a harvest attempt polls the
  copy's CUDA event without blocking, so the stamp opens at the first
  poll that finds the group's copy issued and closes when the bytes are
  host-side: the wait for the device step and the copy, as the
  harvesting thread saw it, to within its poll period. A size-prediction
  miss's second read extends it to that read's end;
* ``pack``: host assembly of the stripes (the JPEG scans and headers, the
  H.264 harvest); a JPEG frame that emits nothing has none.

With ``metrics`` set (the server's :class:`~..observability.Metrics`)
the pipeline also observes each dispatch and fetch wait, counts dropped
frames and publishes the D2H-bytes, host-entropy and in-flight gauges.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from .jpeg import META_WORDS_PER_STRIPE, JpegStripeEncoder, StripeOutput, split_meta
from .staging import HostCopy, StagingRing, StagingTicket

logger = logging.getLogger("selkies_tpu_torch.encoder.pipeline")

#: the clock of the batch deadline (a name of its own, so a test can set
#: the time instead of sleeping)
_now = time.monotonic


def _p50(samples) -> float:
    """Median of a bounded timing window (0.0 when empty)."""
    if not samples:
        return 0.0
    s = sorted(samples)
    return float(s[len(s) // 2])


@dataclass
class _FetchGroup:
    """One device-to-host read covering several frames' prefixes,
    concatenated on the device; member i is ``host[start:start + n]`` for
    ``offsets[i] = (start, n)`` (members may differ in size)."""

    copy: HostCopy
    offsets: Tuple[Tuple[int, int], ...]
    host: Optional[np.ndarray] = None
    #: first harvest attempt that found this group's copy issued, and the
    #: members' shared fetch_wait interval once the bytes are host-side
    t_first: Optional[float] = None
    fetch_iv: Optional[Tuple[float, float]] = None


class _Pipeline:
    """Depth-N in-flight queue around one encoder. Items (one per frame)
    carry ``seq``, ``ticket``, ``group`` and ``group_index``; they complete
    strictly in submission order."""

    def __init__(self, base, depth: int, fetch_group: int) -> None:
        self.base = base
        self.depth = depth
        self.fetch_group = max(1, fetch_group)
        self._inflight: deque = deque()
        self._unfetched: list = []
        self._ready: List[Tuple[int, list]] = []
        self._seq = 0
        self.d2h_bytes_total = 0
        self.frames_completed = 0
        #: frames rejected by try_submit because the pipeline was full
        self.frames_dropped_total = 0
        #: pinned staging lane sized so every in-flight frame can hold a
        #: slot without stalling the ring
        self._staging = StagingRing(depth=depth + 1, device=base.device)
        self._dispatch_ms: deque = deque(maxlen=256)
        self._fetch_wait_ms: deque = deque(maxlen=256)
        self.inflight_batches_max = 0
        #: the server's Metrics (None: nothing published)
        self.metrics = None
        #: seq -> {stage: (t_start, t_end)} of harvested frames, pruned
        #: oldest first, so a caller that never pops cannot grow it
        self._trace_out: dict = {}

    # -- profile hooks -----------------------------------------------------

    def _host_frame(self, frame) -> np.ndarray:
        """The host array staged for one frame."""
        return np.asarray(frame, dtype=np.uint8)

    @property
    def n_held(self) -> int:
        """Frames accepted but not yet dispatched (a forming batch)."""
        return 0

    def _start(self, staged, ticket):
        """Run the device step on the staged frame; return its item (seq
        ``self._seq``), queued in ``_unfetched`` or fetched on its own."""
        raise NotImplementedError

    def _prefix(self, item) -> torch.Tensor:
        """The device bytes of ``item`` its fetch group reads."""
        raise NotImplementedError

    def _advance(self, item, block: bool) -> bool:
        """Move one item forward; True when it can be finished."""
        raise NotImplementedError

    def _finish(self, item) -> list:
        """The frame's stripes, from its fetched bytes."""
        raise NotImplementedError

    def _advance_ready(self) -> None:
        """Non-blocking progress on in-flight items before a dispatch."""

    # -- queue -------------------------------------------------------------

    @property
    def n_inflight(self) -> int:
        return len(self._inflight)

    @property
    def inflight_batches(self) -> int:
        """Fetch groups dispatched but not yet on the host (dispatched but
        ungrouped frames count as one forming group)."""
        groups = {id(it.group) for it in self._inflight
                  if it.group is not None and it.group.host is None}
        return len(groups) + (1 if self._unfetched else 0)

    def try_submit(self, frame) -> Optional[int]:
        """Dispatch one frame without ever blocking; None (frame dropped)
        when the pipeline is full (frames held toward a batch count)."""
        self._advance_ready()
        if len(self._inflight) + self.n_held >= self.depth:
            self._count_dropped(1)
            return None
        return self._submit(self.base.adopt(frame))

    def submit(self, frame) -> int:
        """Dispatch one frame; blocks (harvesting the oldest) if full."""
        return self._submit(self.base.adopt(frame))

    def _submit(self, frame) -> int:
        """:meth:`submit` of a frame already handed over (the async
        driver's thread calls it)."""
        while len(self._inflight) >= self.depth:
            self._ready.append(self._drain_one())
        return self._dispatch(frame)

    def _stage(self, frame, ring: StagingRing):
        """(device tensor, ring ticket) for a frame or a stacked batch: a
        host array rides the pinned staging ring; a tensor (already handed
        over) skips it (ticket None)."""
        b = self.base
        if isinstance(frame, torch.Tensor):
            return frame, None
        with b.stream_context():
            return ring.stage(self._host_frame(frame), stream=b.stream)

    def _dispatch(self, frame) -> int:
        t0 = time.perf_counter()
        ts0 = time.monotonic()
        staged, slot = self._stage(frame, self._staging)
        td0 = time.monotonic()
        ticket = StagingTicket(self._staging, slot)
        try:
            item = self._start(staged, ticket)
        except Exception:
            # the slot must not leak busy (release is idempotent)
            ticket.release()
            raise
        if not isinstance(frame, torch.Tensor):
            item.trace["stage"] = (ts0, td0)
        item.trace["dispatch"] = (td0, time.monotonic())
        self._seq += 1
        self._inflight.append(item)
        if len(self._unfetched) >= self.fetch_group:
            self._issue_fetch()
        self._record_dispatch(t0)
        self._advance_ready()
        return item.seq

    # -- fetch -------------------------------------------------------------

    def _issue_fetch(self) -> None:
        """Fetch the pending frames' prefixes in one group."""
        items, self._unfetched = self._unfetched, []
        if items:
            self._start_fetch(items)

    def _start_fetch(self, items) -> None:
        """Concatenate the items' prefixes on the device and start ONE
        non-blocking copy to pinned host memory for the lot."""
        b = self.base
        with b.stream_context():
            parts = [self._prefix(it) for it in items]
            arr = parts[0] if len(parts) == 1 else torch.cat(parts)
            copy = HostCopy(arr, b.stream)
        offsets, pos = [], 0
        for p in parts:
            offsets.append((pos, int(p.shape[0])))
            pos += int(p.shape[0])
        group = _FetchGroup(copy=copy, offsets=tuple(offsets))
        for i, it in enumerate(items):
            it.group = group
            it.group_index = i
        self._note_inflight()

    def _fetched(self, item, block: bool) -> Optional[np.ndarray]:
        """The item's bytes once its group is on the host; None while the
        copy is still running (``block=False``)."""
        if item.group is None:
            if not block:
                return None
            self._issue_fetch()   # flush the partial group
        g = item.group
        if g.host is None:
            if g.t_first is None:
                g.t_first = time.monotonic()
            if not block and not g.copy.ready():
                return None
            t0 = time.perf_counter()
            g.host = g.copy.numpy()
            g.fetch_iv = (g.t_first, time.monotonic())
            self._record_fetch_wait(t0)
            self.d2h_bytes_total += g.host.nbytes
        item.trace["fetch_wait"] = g.fetch_iv
        start, n = g.offsets[item.group_index]
        return g.host[start:start + n]

    # -- harvest -----------------------------------------------------------

    @staticmethod
    def _release(item) -> None:
        if item.ticket is not None:
            item.ticket.release()
            item.ticket = None

    def _complete(self, item) -> Tuple[int, list]:
        try:
            out = self._finish(item)
        finally:
            # the item is already off the deque: even a failed finish
            # must free its staging slot, or the ring stalls
            self._release(item)
        self.frames_completed += 1
        self._trace_store(item.seq, item.trace)
        self._publish_metrics()
        return item.seq, out

    def _drain_one(self) -> Tuple[int, list]:
        item = self._inflight.popleft()
        try:
            self._advance(item, block=True)
        except Exception:
            self._release(item)
            raise
        return self._complete(item)

    def poll(self, flush_partial: bool = True) -> List[Tuple[int, list]]:
        """Harvest completed frames in order (non-blocking).

        ``flush_partial`` ships a partly filled fetch group so frames are
        never stranded when submissions pause. Results accumulate in
        ``_ready`` and are swapped out only at the end: a harvest raising
        mid-pass keeps the frames completed before it for the next call."""
        if self._unfetched and flush_partial:
            self._issue_fetch()
        self._advance_ready()
        while self._inflight and self._advance(self._inflight[0], block=False):
            self._ready.append(self._complete(self._inflight.popleft()))
        out, self._ready = self._ready, []
        return out

    def flush(self) -> List[Tuple[int, list]]:
        """Drain the pipeline (blocking)."""
        while self._inflight:
            self._ready.append(self._drain_one())
        out, self._ready = self._ready, []
        return out

    def close(self) -> None:
        """Abandon in-flight work: drop device handles and release every
        staging slot so a rebuilt pipeline never inherits a busy ring."""
        self._inflight.clear()
        self._unfetched.clear()
        self._ready.clear()
        self._trace_out.clear()
        self._staging.release_all()

    # -- telemetry ---------------------------------------------------------

    def _trace_store(self, seq: int, intervals: dict) -> None:
        if not intervals:
            return
        self._trace_out[seq] = intervals
        while len(self._trace_out) > 4 * max(8, self.depth):
            self._trace_out.pop(next(iter(self._trace_out)))

    def pop_trace(self, seq: int):
        """Stage intervals of a harvested frame (once; None if unknown)."""
        return self._trace_out.pop(seq, None)

    def _record_dispatch(self, t0: float) -> None:
        ms = (time.perf_counter() - t0) * 1000.0
        self._dispatch_ms.append(ms)
        self._note_inflight()
        if self.metrics is not None:
            self.metrics.observe_dispatch(ms)

    def _record_fetch_wait(self, t0: float) -> None:
        ms = (time.perf_counter() - t0) * 1000.0
        self._fetch_wait_ms.append(ms)
        if self.metrics is not None:
            self.metrics.observe_fetch_wait(ms)

    def _count_dropped(self, n: int) -> None:
        if n <= 0:
            return
        self.frames_dropped_total += n
        if self.metrics is not None:
            self.metrics.inc_frames_dropped(n)

    def _publish_metrics(self) -> None:
        if self.metrics is not None and self.frames_completed:
            st = self.stats()
            self.metrics.set_d2h_bytes_per_frame(st["d2h_bytes_per_frame"])
            self.metrics.set_host_entropy_ms_per_frame(
                st["host_entropy_ms_per_frame"])
            self.metrics.set_inflight_batches(st["inflight_batches"])

    def _note_inflight(self) -> None:
        self.inflight_batches_max = max(self.inflight_batches_max,
                                        self.inflight_batches)

    def _pipeline_stats(self) -> dict:
        return {
            "frames": self.frames_completed,
            "frames_dropped": self.frames_dropped_total,
            "staging_stalls": self._staging.stalls_total,
            "inflight_batches": self.inflight_batches,
            "inflight_batches_max": self.inflight_batches_max,
            "dispatch_p50_ms": round(_p50(self._dispatch_ms), 3),
            "fetch_wait_p50_ms": round(_p50(self._fetch_wait_ms), 3),
        }


@dataclass
class _InFlight:
    seq: int
    paint_candidate: np.ndarray
    packed: Any                     # full device buffer (meta head + words)
    yq: Any
    cbq: Any
    crq: Any
    group: Optional[_FetchGroup] = None
    group_index: int = 0
    guess_words: int = 0
    meta_done: bool = False
    emit: Optional[np.ndarray] = None
    is_paint: Optional[np.ndarray] = None
    refetch: Optional[HostCopy] = None  # second read when prediction missed
    meta: Tuple[Optional[np.ndarray], ...] = (None, None, None)
    words_np: Optional[np.ndarray] = None
    ticket: Optional[StagingTicket] = None
    #: the frame's stage intervals for the flight recorder
    trace: dict = field(default_factory=dict)


class PipelinedJpegEncoder(_Pipeline):
    """Depth-N pipelined wrapper around a :class:`JpegStripeEncoder`.

    Usage::

        enc = PipelinedJpegEncoder(JpegStripeEncoder(w, h))
        enc.submit(frame)                 # non-blocking dispatch
        for seq, stripes in enc.poll():   # harvest whatever completed
            ...
        enc.flush()                       # drain everything (blocking)
    """

    def __init__(self, base: JpegStripeEncoder, depth: int = 8,
                 fetch_group: int = 1) -> None:
        super().__init__(base, depth, fetch_group)
        self._meta_words = META_WORDS_PER_STRIPE * base.n_stripes
        self._guess = base._packer.bucket_words(8192)
        self.host_entropy_ms_total = 0.0

    def stats(self) -> dict:
        """Per-frame transfer/host-entropy gauges over the run so far."""
        n = max(1, self.frames_completed)
        return {
            **self._pipeline_stats(),
            "d2h_bytes_per_frame": self.d2h_bytes_total / n,
            "host_entropy_ms_per_frame": self.host_entropy_ms_total / n,
            "host_fallback_stripes": self.base.host_fallback_stripes_total,
        }

    def force_keyframe(self) -> None:
        """Next frame emits every stripe (viewer join / pipeline reset)."""
        self.base.force_keyframe()

    def _host_frame(self, frame) -> np.ndarray:
        return self.base._pad(np.asarray(frame, dtype=np.uint8))

    def _start(self, staged, ticket) -> _InFlight:
        b = self.base
        paint_candidate = b._paint_candidates().copy()
        # Optimistic mark: frames submitted while this one is in flight must
        # not re-trigger the same paint-over (a damaged stripe clears the
        # mark again at harvest in _decide_emits).
        b._painted |= paint_candidate
        with b.stream_context():
            packed, yq, cbq, crq = b._step(
                staged, b._prev, b._recip_y, b._recip_c,
                b._qsel(paint_candidate), b._wm_scaled, b._alpha_inv)
        item = _InFlight(
            seq=self._seq, paint_candidate=paint_candidate,
            packed=packed, yq=yq, cbq=cbq, crq=crq, ticket=ticket,
        )
        self._unfetched.append(item)
        return item

    def _prefix(self, item: _InFlight) -> torch.Tensor:
        item.guess_words = self._guess
        return item.packed[:self._meta_words + self._guess]

    def _advance_ready(self) -> None:
        """Advance in-flight items in submission order (non-blocking).

        ``_decide_emits`` mutates shared damage/paint history, so the meta
        stage must run strictly in frame order."""
        meta_ok = True
        for item in self._inflight:
            if not meta_ok:
                break
            self._advance(item, block=False)
            meta_ok = item.meta_done

    def _advance(self, item: _InFlight, block: bool) -> bool:
        b = self.base
        if not item.meta_done:
            buf = self._fetched(item, block)
            if buf is None:
                return False
            nbytes_np, base_np, ovf_np, damage_np = split_meta(
                buf[: self._meta_words], b.n_stripes)
            emit, is_paint = b._decide_emits(
                damage_np > b.damage_threshold, item.paint_candidate)
            item.emit, item.is_paint = emit, is_paint
            item.meta = (nbytes_np, base_np, ovf_np)
            item.meta_done = True
            total = b.total_packed_words(base_np, nbytes_np)
            if emit.any():
                if total <= item.guess_words:
                    item.words_np = buf[self._meta_words:]
                else:  # prediction miss: one more read for the full payload
                    bucket = b._packer.bucket_words(total)
                    with b.stream_context():
                        item.refetch = HostCopy(
                            item.packed[self._meta_words:
                                        self._meta_words + bucket], b.stream)
            # adapt: track the frame size plus one bucket of headroom
            target = b._packer.bucket_words(max(total * 2, 8192))
            self._guess = max(target, self._guess // 2)
            item.packed = None  # release our handle; refetch holds its data
        if item.refetch is not None and item.words_np is None:
            if not block and not item.refetch.ready():
                return False
            tm0 = time.monotonic()
            item.words_np = item.refetch.numpy()
            # a prediction miss's second read extends the fetch wait
            fw = item.trace.get("fetch_wait")
            item.trace["fetch_wait"] = (fw[0] if fw else tm0,
                                        time.monotonic())
            self.d2h_bytes_total += item.words_np.nbytes
        return True

    def _finish(self, item: _InFlight) -> List[StripeOutput]:
        b = self.base
        nbytes_np, base_np, ovf_np = item.meta
        emit, is_paint = item.emit, item.is_paint
        if not emit.any() or item.words_np is None:
            return []
        t0 = time.monotonic()
        scans = b._scans_from_packed(
            item.words_np, base_np, nbytes_np, ovf_np,
            emit, item.yq, item.cbq, item.crq)
        out = b._assemble(emit, is_paint, scans)
        t1 = time.monotonic()
        item.trace["pack"] = (t0, t1)
        self.host_entropy_ms_total += (t1 - t0) * 1000.0
        return out


@dataclass
class _H264InFlight:
    seq: int
    pending: Any                     # h264._H264Pending
    group: Optional[_FetchGroup] = None
    group_index: int = 0
    host: Optional[np.ndarray] = None
    ticket: Optional[StagingTicket] = None
    #: the frame's stage intervals for the flight recorder
    trace: dict = field(default_factory=dict)


class PipelinedH264Encoder(_Pipeline):
    """Depth-N pipelined wrapper around :class:`~.h264.H264StripeEncoder`,
    with grouped head fetches and, with ``batch`` > 1, B frames per
    device dispatch.

    Several P frames' heads are concatenated on the device and fetched in
    ONE non-blocking copy; an IDR frame fetches its exact levels on its own
    (keyframes are rare: connect, reset, PLI). Frames complete strictly in
    submission order: ``harvest`` advances per-stripe frame numbers and
    damage history.

    ``batch`` > 1: :meth:`submit` holds frames until ``batch`` of them
    are there, then dispatches them in one batched step
    (``H264StripeEncoder.dispatch_batch``), whose heads are one fetch;
    :meth:`submit_batch` takes a stacked (B, H, W, 3) batch at once. A
    partial batch (the caller paused for ``batch_deadline_s`` since its
    last submit, a ``poll(flush_partial=True)``, or :meth:`flush`) goes
    through the one-frame step frame by frame. Host frames of a batch are
    stacked and staged in one upload (a second staging ring, for the
    stacked shape); frame tensors on the encoder's device skip staging."""

    def __init__(self, base, depth: int = 8, fetch_group: int = 4,
                 batch: int = 1) -> None:
        super().__init__(base, depth, fetch_group)
        self.batch = max(1, int(batch))
        if depth < self.batch:
            # a batch could never fill: held frames would ship one by one
            raise ValueError(f"depth {depth} is less than batch {batch}")
        #: a forming batch ships partial once no frame was submitted for
        #: this long (2.5 frame times of a 60 fps batch, at least 50 ms):
        #: the deadline is re-armed by every submit, so it detects a
        #: paused caller, not a slow one (a stream ticking slower than
        #: batch/deadline still fills whole batches; no frame waits longer
        #: than ``batch`` deadlines)
        self.batch_deadline_s = max(0.05, 2.5 * self.batch / 60.0)
        self._batch_frames: list = []
        self._batch_last = 0.0
        self._staging_batch = StagingRing(
            depth=max(2, -(-depth // self.batch) + 1), device=base.device)

    @property
    def n_held(self) -> int:
        return len(self._batch_frames)

    def stats(self) -> dict:
        """Per-frame transfer/host-entropy gauges over the run so far: D2H
        counts grouped head reads, IDR level reads and the encoder's
        undershoot/overflow re-reads. ``frames_dropped`` counts frames
        refused when full and the other frames of a batch whose dispatch
        failed."""
        n = max(1, self.frames_completed)
        b = self.base
        return {
            **self._pipeline_stats(),
            "staging_stalls": (self._staging.stalls_total
                               + self._staging_batch.stalls_total),
            "batch": self.batch,
            "d2h_bytes_per_frame":
                (self.d2h_bytes_total + b.d2h_refetch_bytes_total) / n,
            "host_entropy_ms_per_frame": b.host_entropy_ms_total / n,
            "entropy_errors": b.entropy_errors_total,
            "host_coded_stripes": b.host_coded_stripes_total,
        }

    def request_keyframe(self) -> None:
        self.base.request_keyframe()

    #: the async driver's name for it (the server calls it when a viewer
    #: joins a running display)
    force_keyframe = request_keyframe

    # -- batching ------------------------------------------------------------

    def _submit(self, frame) -> int:
        """Submit one frame (dispatched at once with ``batch`` 1, else
        held toward a batch); blocks (harvesting the oldest) if full."""
        while len(self._inflight) + len(self._batch_frames) >= self.depth:
            if not self._inflight:
                self._flush_batch()
                continue
            self._ready.append(self._drain_one())
        if self.batch == 1:
            return self._dispatch(frame)
        seq = self._seq + len(self._batch_frames)
        self._batch_last = _now()
        self._batch_frames.append(frame)
        if len(self._batch_frames) >= self.batch:
            self._flush_batch()
        return seq

    def submit_batch(self, rgbs) -> List[int]:
        """Submit a stacked (B, H, W, 3) batch (a host array, or a tensor
        on the encoder's device) as one dispatch; returns its seqs."""
        rgbs = self.base.adopt(rgbs)
        while len(self._inflight) >= self.depth:
            self._ready.append(self._drain_one())
        self._flush_batch()                  # frames held before it first
        first = self._seq
        self._dispatch_batch(rgbs)
        return list(range(first, self._seq))

    def _batch_deadline_due(self) -> bool:
        """The caller submitted nothing for a whole deadline."""
        return _now() - self._batch_last > self.batch_deadline_s

    def _flush_batch(self) -> None:
        """Dispatch the held frames: a whole batch as one batched step, a
        partial one frame by frame through the one-frame step. When a
        dispatch raises, the one exception reaches the caller and the
        batch's other frames are counted as drops."""
        frames, self._batch_frames = self._batch_frames, []
        if not frames:
            return
        if len(frames) < self.batch:
            for i, frame in enumerate(frames):
                try:
                    self._dispatch(frame)
                except Exception:
                    self._count_dropped(len(frames) - i - 1)
                    self._issue_fetch()
                    raise
            self._issue_fetch()
            return
        try:
            self._dispatch_batch(self._stack(frames))
        except Exception:
            self._count_dropped(len(frames) - 1)
            raise

    def _stack(self, frames):
        """One (B, H, W, 3) batch: stacked on the host when every frame is
        a host array (staged in one upload), else on the device."""
        if not any(isinstance(f, torch.Tensor) for f in frames):
            return np.stack([np.asarray(f, dtype=np.uint8) for f in frames])
        b = self.base
        with b.stream_context():
            return torch.stack([f if isinstance(f, torch.Tensor)
                                else b._upload(np.asarray(f, np.uint8))
                                for f in frames])

    def _dispatch_batch(self, rgbs) -> None:
        """One batched dispatch. The staged buffer backs every frame of
        the batch, so its ring slot frees when the last of them is
        harvested; the batch's heads are one fetch."""
        t0 = time.perf_counter()
        ts0 = time.monotonic()
        staged, slot = self._stage(rgbs, self._staging_batch)
        td0 = time.monotonic()
        try:
            pendings = self.base._dispatch_batch(staged, fetch=False)
        except Exception:
            self._staging_batch.release(slot)
            raise
        td1 = time.monotonic()
        ticket = StagingTicket(self._staging_batch, slot,
                               refs=len(pendings))
        batched = []
        for p in pendings:
            item = self._item(p, ticket)
            # one staged buffer and one step back the whole batch: every
            # member frame was gated by the same intervals
            if not isinstance(rgbs, torch.Tensor):
                item.trace["stage"] = (ts0, td0)
            item.trace["dispatch"] = (td0, td1)
            self._seq += 1
            self._inflight.append(item)
            if p.batch_heads is not None:
                batched.append(item)
        if batched:
            self._start_fetch(batched)       # the batch's heads: one read
        self._issue_fetch()
        self._record_dispatch(t0)

    # -- profile hooks ---------------------------------------------------------

    def _item(self, p, ticket) -> _H264InFlight:
        """The in-flight item of a dispatched frame; an IDR frame's exact
        levels are fetched on their own, a P frame (not of a batch) joins
        the forming fetch group."""
        item = _H264InFlight(seq=self._seq, pending=p, ticket=ticket)
        if p.is_idr:
            self._start_fetch([item])
        elif p.batch_heads is None:
            self._unfetched.append(item)
        return item

    def _start(self, staged, ticket) -> _H264InFlight:
        return self._item(self.base._dispatch(staged, fetch=False), ticket)

    def _prefix(self, item: _H264InFlight) -> torch.Tensor:
        p = item.pending
        if p.batch_heads is not None:
            return p.batch_heads[p.batch_index]
        return p.flat16 if p.is_idr else p.head

    def _advance(self, item: _H264InFlight, block: bool) -> bool:
        if item.host is None:
            item.host = self._fetched(item, block)
        return item.host is not None

    def _finish(self, item: _H264InFlight) -> list:
        t0 = time.monotonic()
        out = self.base.harvest(item.pending, host=item.host)
        item.trace["pack"] = (t0, time.monotonic())
        return out

    # -- queue -------------------------------------------------------------------

    def poll(self, flush_partial: bool = True) -> List[Tuple[int, list]]:
        """As :meth:`_Pipeline.poll`; a forming batch ships partial with
        ``flush_partial`` or once its deadline is due."""
        if self._batch_frames and (flush_partial
                                   or self._batch_deadline_due()):
            self._flush_batch()
        return super().poll(flush_partial)

    def flush(self) -> List[Tuple[int, list]]:
        """Dispatch a forming batch, then drain the pipeline (blocking)."""
        self._flush_batch()
        return super().flush()

    def close(self) -> None:
        self._batch_frames.clear()
        super().close()
        self._staging_batch.release_all()


class ThreadedEncoderAdapter:
    """submit()/poll()/flush() facade over a synchronous ``encode_frame``
    encoder (the host-entropy rungs of both codecs), keeping the event loop
    free: one worker thread encodes frames in submission order, and a
    bounded queue drops frames under overload exactly as ``try_submit``
    does.

    On the card the worker runs every call of the encoder inside its
    ``stream_context()``: PyTorch's current stream is per thread, and every
    encoder on a card runs on the card's one encoder stream. ``submit``
    hands a frame tensor over in the caller's thread; the worker encodes
    it with the encoder's ``_encode_frame``, which takes it as it is.

    Capture-loop surface: ``try_submit`` / ``poll`` / ``flush`` /
    ``force_keyframe`` / ``close`` / ``join`` / ``stats`` / ``pop_trace`` /
    ``on_error`` / ``metrics``, plus ``wire_fullframe`` for the server's
    packer.
    """

    def __init__(self, base, depth: int = 3,
                 wire_fullframe: bool = False) -> None:
        self.base = base
        self.depth = depth
        #: ship as one 0x00 full-frame packet instead of 0x04 stripes
        self.wire_fullframe = bool(wire_fullframe)
        #: called with the exception for every errored frame (in the thread
        #: that polls or flushes); the server's capture loop counts it on
        #: the display's degradation ladder
        self.on_error = None
        #: the server's Metrics (dropped frames, encode errors)
        self.metrics = None
        self._cond = threading.Condition()
        self._in_q: deque = deque()        # (seq, frame) not yet started
        self._out: deque = deque()         # (seq, stripes | exc, interval)
        self._seq = 0
        self._finished = 0                 # frames the worker is done with
        self._stop = False
        self.frames_completed = 0
        self.frames_dropped_total = 0
        self.encode_errors_total = 0
        self._encode_ms: deque = deque(maxlen=256)
        #: per-frame intervals of the encode (all of it is "pack": there is
        #: no separate device dispatch to attribute)
        self._trace_out: dict = {}
        self._thread = threading.Thread(target=self._run,
                                        name="torchenc-host", daemon=True)
        self._thread.start()

    # -- capture-loop surface -----------------------------------------------

    def stats(self) -> dict:
        """Drop/error accounting plus the base encoder's transfer and
        host-entropy gauges (the pipelined encoders' stats keys)."""
        n = max(1, self.frames_completed)
        b = self.base
        d2h = (getattr(b, "d2h_fetch_bytes_total", 0)
               + getattr(b, "d2h_refetch_bytes_total", 0))
        with self._cond:
            encode_ms = list(self._encode_ms)
        return {
            "frames": self.frames_completed,
            "frames_dropped": self.frames_dropped_total,
            "encode_errors": self.encode_errors_total,
            "encode_p50_ms": round(_p50(encode_ms), 3),
            "d2h_bytes_per_frame": d2h / n,
            "host_entropy_ms_per_frame":
                getattr(b, "host_entropy_ms_total", 0.0) / n,
            "entropy_errors": getattr(b, "entropy_errors_total", 0),
            "host_coded_stripes": getattr(b, "host_coded_stripes_total", 0),
            "entropy": getattr(b, "entropy", None),
        }

    def try_submit(self, frame) -> Optional[int]:
        """Queue one frame; None (dropped) when ``depth`` frames are
        already queued or encoding."""
        with self._cond:
            if self._stop:
                return None
            if self._seq - self._finished >= self.depth:
                self.frames_dropped_total += 1
                if self.metrics is not None:
                    self.metrics.inc_frames_dropped()
                return None
        return self.submit(frame)

    def submit(self, frame) -> Optional[int]:
        """Queue one frame whatever the queue's length (None once
        closed). A host frame larger than the encoder is cropped to it
        (the H.264 encoders take even dimensions, a source may not); a
        frame tensor is handed over in the caller's thread
        (``base.adopt``; the worker takes it as it is)."""
        h = getattr(self.base, "height", None)
        w = getattr(self.base, "width", None)
        if isinstance(frame, torch.Tensor):
            frame = self.base.adopt(frame)
        elif (h is not None and frame.shape[0] >= h and frame.shape[1] >= w
              and tuple(frame.shape[:2]) != (h, w)):
            frame = frame[:h, :w]
        with self._cond:
            if self._stop:
                return None
            seq = self._seq
            self._seq += 1
            self._in_q.append((seq, frame))
            self._cond.notify_all()
        return seq

    def poll(self) -> List[Tuple[int, list]]:
        """The frames the worker finished, in submission order (never
        blocks)."""
        with self._cond:
            done = list(self._out)
            self._out.clear()
        return self._settle(done)

    def flush(self, timeout: float = 60.0) -> List[Tuple[int, list]]:
        """Wait until every queued frame is encoded (or failed), then
        return them. Blocks: warm-up and teardown only."""
        with self._cond:
            self._cond.wait_for(
                lambda: self._finished >= self._seq or self._stop
                or not self._thread.is_alive(), timeout=timeout)
            done = list(self._out)
            self._out.clear()
        return self._settle(done)

    def pop_trace(self, seq: int):
        """The encode interval of a harvested frame (once; None if
        unknown)."""
        return self._trace_out.pop(seq, None)

    def request_keyframe(self) -> None:
        rk = getattr(self.base, "request_keyframe", None)
        if rk is not None:
            rk()
        else:
            self.base.force_keyframe()

    force_keyframe = request_keyframe

    def close(self) -> None:
        """Stop the worker and abandon queued frames (display teardown).
        Never blocks: a frame already encoding finishes on the worker,
        which then exits; :meth:`join` waits for that."""
        with self._cond:
            self._stop = True
            self._in_q.clear()
            self._out.clear()
            self._cond.notify_all()
        self._trace_out.clear()

    def join(self, timeout: Optional[float] = None) -> bool:
        """Wait for the worker to exit after :meth:`close`; True when it
        has."""
        self._thread.join(timeout)
        return not self._thread.is_alive()

    # -- worker ---------------------------------------------------------------

    def _settle(self, done) -> List[Tuple[int, list]]:
        """Results of finished frames; an errored frame is counted and
        reported to ``on_error``, and costs only itself."""
        out = []
        for seq, res, iv in done:
            if isinstance(res, Exception):
                self.encode_errors_total += 1
                if self.metrics is not None:
                    self.metrics.inc_encode_errors()
                logger.error("encode of frame %d failed", seq, exc_info=res)
                if self.on_error is not None:
                    try:
                        self.on_error(res)
                    except Exception:
                        logger.exception("on_error hook failed")
                continue
            out.append((seq, res))
            self.frames_completed += 1
            self._trace_out[seq] = {"pack": iv}
            while len(self._trace_out) > 4 * max(8, self.depth):
                self._trace_out.pop(next(iter(self._trace_out)))
        return out

    def _run(self) -> None:
        while True:
            with self._cond:
                self._cond.wait_for(lambda: self._in_q or self._stop)
                if self._stop:
                    return
                seq, frame = self._in_q.popleft()
            t0 = time.monotonic()
            try:
                with self.base.stream_context():
                    res = self.base._encode_frame(frame)
            except Exception as exc:     # reported by _settle
                res = exc
            t1 = time.monotonic()
            with self._cond:
                self._encode_ms.append((t1 - t0) * 1000.0)
                self._out.append((seq, res, (t0, t1)))
                self._finished += 1
                self._cond.notify_all()

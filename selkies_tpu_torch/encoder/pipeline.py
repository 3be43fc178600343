"""Pipelined JPEG encoder: overlaps device steps, device-to-host copies and
host assembly (counterpart of ``selkies_tpu/encoder/pipeline.py:36-471``).

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
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from .jpeg import META_WORDS_PER_STRIPE, JpegStripeEncoder, StripeOutput, split_meta
from .staging import StagingRing, StagingTicket


def _p50(samples) -> float:
    """Median of a bounded timing window (0.0 when empty)."""
    if not samples:
        return 0.0
    s = sorted(samples)
    return float(s[len(s) // 2])


class _PipelineTelemetry:
    """Dispatch/fetch instrumentation: bounded timing windows and the
    in-flight high-water mark."""

    def _init_telemetry(self) -> None:
        self._dispatch_ms: deque = deque(maxlen=256)
        self._fetch_wait_ms: deque = deque(maxlen=256)
        self.inflight_batches_max = 0

    def _note_inflight(self) -> None:
        self.inflight_batches_max = max(self.inflight_batches_max,
                                        self.inflight_batches)

    def _record_dispatch(self, ms: float) -> None:
        self._dispatch_ms.append(ms)
        self._note_inflight()

    def _record_fetch_wait(self, ms: float) -> None:
        self._fetch_wait_ms.append(ms)

    def _telemetry_stats(self) -> dict:
        return {
            "inflight_batches": self.inflight_batches,
            "inflight_batches_max": self.inflight_batches_max,
            "dispatch_p50_ms": round(_p50(self._dispatch_ms), 3),
            "fetch_wait_p50_ms": round(_p50(self._fetch_wait_ms), 3),
        }


class _HostCopy:
    """One device-to-host copy in flight: a pinned host tensor, filled by a
    ``non_blocking`` copy on the encoder's stream, and the event recorded
    after it. On the CPU the "copy" is the tensor itself and is done."""

    __slots__ = ("host", "event")

    def __init__(self, src: torch.Tensor, stream) -> None:
        if stream is None:
            self.host, self.event = src, None
            return
        self.host = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
        self.host.copy_(src, non_blocking=True)
        self.event = torch.cuda.Event()
        self.event.record(stream)

    def ready(self) -> bool:
        return self.event is None or self.event.query()

    def numpy(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


@dataclass
class _FetchGroup:
    """One device-to-host read covering several frames' packed prefixes,
    concatenated on the device."""

    copy: _HostCopy
    stride: int = 0
    host: Optional[np.ndarray] = None


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
    refetch: Optional[_HostCopy] = None  # second read when prediction missed
    meta: Tuple[Optional[np.ndarray], ...] = (None, None, None)
    words_np: Optional[np.ndarray] = None
    ticket: Optional[StagingTicket] = None


class PipelinedJpegEncoder(_PipelineTelemetry):
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
        self.base = base
        self.depth = depth
        self.fetch_group = max(1, fetch_group)
        self._inflight: deque[_InFlight] = deque()
        self._unfetched: List[_InFlight] = []
        self._ready: List[Tuple[int, List[StripeOutput]]] = []
        self._seq = 0
        self._meta_words = META_WORDS_PER_STRIPE * base.n_stripes
        self._guess = base._packer.bucket_words(8192)
        self.d2h_bytes_total = 0
        self.host_entropy_ms_total = 0.0
        self.frames_completed = 0
        #: frames rejected by try_submit because the pipeline was full
        self.frames_dropped_total = 0
        #: pinned staging lane sized so every in-flight frame can hold a
        #: slot without stalling the ring
        self._staging = StagingRing(depth=depth + 1, device=base.device)
        self._init_telemetry()

    @property
    def inflight_batches(self) -> int:
        """Fetch groups dispatched but not yet materialized on the host
        (dispatched-but-ungrouped frames count as one forming group)."""
        groups = {id(it.group) for it in self._inflight
                  if it.group is not None and it.group.host is None}
        return len(groups) + (1 if self._unfetched else 0)

    def stats(self) -> dict:
        """Per-frame transfer/host-entropy gauges over the run so far."""
        n = max(1, self.frames_completed)
        return {
            "frames": self.frames_completed,
            "d2h_bytes_per_frame": self.d2h_bytes_total / n,
            "host_entropy_ms_per_frame": self.host_entropy_ms_total / n,
            "frames_dropped": self.frames_dropped_total,
            "host_fallback_stripes": self.base.host_fallback_stripes_total,
            "staging_stalls": self._staging.stalls_total,
            **self._telemetry_stats(),
        }

    @property
    def n_inflight(self) -> int:
        return len(self._inflight)

    def force_keyframe(self) -> None:
        """Next frame emits every stripe (viewer join / pipeline reset)."""
        self.base.force_keyframe()

    def try_submit(self, frame) -> Optional[int]:
        """Dispatch one frame without ever blocking; None (frame dropped)
        when the pipeline is full."""
        self._advance_ready()
        if len(self._inflight) >= self.depth:
            self.frames_dropped_total += 1
            return None
        return self._dispatch(frame)

    def submit(self, frame) -> int:
        """Dispatch one frame; blocks (harvesting the oldest) if full."""
        while len(self._inflight) >= self.depth:
            self._ready.append(self._drain_one())
        return self._dispatch(frame)

    def _dispatch(self, frame) -> int:
        b = self.base
        t0 = time.perf_counter()
        with b.stream_context():
            frame, slot = self._staging.stage(
                b._pad(np.asarray(frame, dtype=np.uint8)), stream=b.stream)
        ticket = StagingTicket(self._staging, slot)
        try:
            return self._dispatch_staged(frame, ticket, t0)
        except Exception:
            # the slot must not leak busy (release is idempotent)
            ticket.release()
            raise

    def _dispatch_staged(self, frame, ticket, t0) -> int:
        b = self.base
        paint_candidate = b._paint_candidates().copy()
        # Optimistic mark: frames submitted while this one is in flight must
        # not re-trigger the same paint-over (a damaged stripe clears the
        # mark again at harvest in _decide_emits).
        b._painted |= paint_candidate
        with b.stream_context():
            packed, yq, cbq, crq = b._step(
                frame, b._prev, b._recip_y, b._recip_c,
                b._qsel(paint_candidate), b._wm_scaled, b._alpha_inv)
        item = _InFlight(
            seq=self._seq, paint_candidate=paint_candidate,
            packed=packed, yq=yq, cbq=cbq, crq=crq, ticket=ticket,
        )
        self._seq += 1
        self._inflight.append(item)
        self._unfetched.append(item)
        if len(self._unfetched) >= self.fetch_group:
            self._issue_fetch()
        self._record_dispatch((time.perf_counter() - t0) * 1000.0)
        self._advance_ready()
        return item.seq

    def _issue_fetch(self) -> None:
        """Concatenate the pending frames' prefixes on the device and start
        ONE non-blocking copy to pinned host memory for the lot."""
        group_items, self._unfetched = self._unfetched, []
        if not group_items:
            return
        b = self.base
        guess = self._guess
        stride = self._meta_words + guess
        with b.stream_context():
            slices = [it.packed[:stride] for it in group_items]
            arr = slices[0] if len(slices) == 1 else torch.cat(slices)
            group = _FetchGroup(copy=_HostCopy(arr, b.stream), stride=stride)
        for i, it in enumerate(group_items):
            it.group = group
            it.group_index = i
            it.guess_words = guess
        self._note_inflight()

    # -- pipeline stages ---------------------------------------------------

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
        """Move one item forward; returns True when fully harvestable."""
        b = self.base
        if not item.meta_done:
            if item.group is None:
                if not block:
                    return False
                self._issue_fetch()   # flush the partial group
            if not block and not item.group.copy.ready():
                return False
            if item.group.host is None:
                t0 = time.perf_counter()
                item.group.host = item.group.copy.numpy()
                self._record_fetch_wait((time.perf_counter() - t0) * 1000.0)
                self.d2h_bytes_total += item.group.host.nbytes
            stride = item.group.stride
            buf = item.group.host[item.group_index * stride:
                                  (item.group_index + 1) * stride]
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
                        item.refetch = _HostCopy(
                            item.packed[self._meta_words:
                                        self._meta_words + bucket], b.stream)
            # adapt: track the frame size plus one bucket of headroom
            target = b._packer.bucket_words(max(total * 2, 8192))
            self._guess = max(target, self._guess // 2)
            item.packed = None  # release our handle; refetch holds its data
        if item.refetch is not None and item.words_np is None:
            if not block and not item.refetch.ready():
                return False
            item.words_np = item.refetch.numpy()
            self.d2h_bytes_total += item.words_np.nbytes
        return True

    def _finish(self, item: _InFlight) -> List[StripeOutput]:
        b = self.base
        self.frames_completed += 1
        if item.ticket is not None:
            item.ticket.release()
            item.ticket = None
        nbytes_np, base_np, ovf_np = item.meta
        emit, is_paint = item.emit, item.is_paint
        if not emit.any() or item.words_np is None:
            return []
        t0 = time.perf_counter()
        scans = b._scans_from_packed(
            item.words_np, base_np, nbytes_np, ovf_np,
            emit, item.yq, item.cbq, item.crq)
        out = b._assemble(emit, is_paint, scans)
        self.host_entropy_ms_total += (time.perf_counter() - t0) * 1000.0
        return out

    def _drain_one(self) -> Tuple[int, List[StripeOutput]]:
        item = self._inflight.popleft()
        try:
            self._advance(item, block=True)
        except Exception:
            # already off the deque: a failed fetch must still free its slot
            if item.ticket is not None:
                item.ticket.release()
                item.ticket = None
            raise
        return item.seq, self._finish(item)

    # -- public harvest ----------------------------------------------------

    def poll(self, flush_partial: bool = True
             ) -> List[Tuple[int, List[StripeOutput]]]:
        """Harvest all completed frames (non-blocking, in order).

        ``flush_partial`` issues any partially filled fetch group so frames
        are never stranded when submissions pause."""
        if self._unfetched and flush_partial:
            self._issue_fetch()
        self._advance_ready()
        while self._inflight and self._advance(self._inflight[0], block=False):
            item = self._inflight.popleft()
            self._ready.append((item.seq, self._finish(item)))
        out, self._ready = self._ready, []
        return out

    def flush(self) -> List[Tuple[int, List[StripeOutput]]]:
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
        self._staging.release_all()

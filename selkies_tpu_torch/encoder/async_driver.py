"""Async pipeline driver (the port's copy of ``selkies_tpu/encoder/async_driver.py``).

:class:`AsyncEncodeDriver` keeps the chip from idling on the host:

* the capture loop's ``try_submit``/``poll`` are pure queue operations —
  no device interaction ever runs on the event loop;
* a dedicated driver thread owns the pipelined encoder
  (:mod:`.pipeline`) and keeps >=2 frames in flight end-to-end: dispatch
  of frame N+1 is issued while frame N's non-blocking device-to-host
  copy completes;
* host frames go through the pinned staging ring
  (:class:`.staging.StagingRing`), so the upload overlaps the previous
  frame's compute;
* a bounded submit queue gives backpressure (frames drop at the edge,
  counted, instead of stalling every display on the loop);
* ``flush()`` drains deterministically; ``close()`` mid-flight neither
  deadlocks nor leaks a staging slot;
* each harvested frame's stage intervals (flight recorder) are taken from
  the pipe on the driver thread and kept under the driver seq
  ``try_submit`` returned, for the capture loop's :meth:`pop_trace`.

CUDA streams are per thread in PyTorch. The driver thread never issues
device work of its own: every device call goes through the pipeline,
which runs it on the pipeline's one explicit stream, so events recorded
there and queried here see the same queue.
"""

from __future__ import annotations

import logging
import threading
from collections import deque
from typing import Callable, List, Optional, Tuple

logger = logging.getLogger("selkies_tpu_torch.encoder.async_driver")

#: fault point checked at the harvest site (``robustness.faults``): an
#: armed ``fetch.hang`` wedges the driver thread as a dead D2H copy would
FETCH_HANG_POINT = "fetch.hang"


class AsyncEncodeDriver:
    """Non-blocking facade + driver thread around a pipelined encoder.

    ``pipe`` is a :class:`~.pipeline.PipelinedJpegEncoder` or
    :class:`~.pipeline.PipelinedH264Encoder`; the driver is its only user
    after construction, so the pipe needs no locking of its own.

    Capture-loop surface: ``try_submit`` / ``poll`` / ``flush`` /
    ``force_keyframe`` / ``close`` / ``stats`` / ``pop_trace`` /
    ``on_error`` / ``metrics`` — plus ``wire_fullframe`` for the server's
    stripe packer.
    """

    #: seconds the driver thread sleeps between harvest polls when work
    #: is in flight but nothing is ready (an ``is_ready`` check is
    #: cheap; the short beat keeps both submit and harvest latency low)
    POLL_INTERVAL_S = 0.002

    def __init__(self, pipe, *, flush_partial_when_idle: bool = True,
                 wire_fullframe: bool = False) -> None:
        self.pipe = pipe
        self.submit_depth = max(4, pipe.depth)
        #: JPEG / batch=1 H.264: ship a partial fetch group as soon as the
        #: submit queue runs dry (lowest latency). Batched H.264 keeps
        #: False, so that the pipe's re-armed batch deadline, not every
        #: idle poll, decides when a partial batch ships.
        self.flush_partial_when_idle = bool(flush_partial_when_idle)
        #: ship each frame as one 0x00 full-frame packet instead of 0x04
        #: stripes (the x264enc profile); read by the server only
        self.wire_fullframe = bool(wire_fullframe)
        #: called with the exception for every frame lost to a
        #: device/entropy error (driver thread context); the server's
        #: capture loop counts it on the display's degradation ladder
        self.on_error: Optional[Callable[[BaseException], None]] = None
        #: the server's FaultInjector (None: no fault points checked)
        self.faults = None
        self._metrics = None

        self._cond = threading.Condition()
        self._in_q: deque = deque()          # (driver_seq, frame)
        self._out: deque = deque()           # (driver_seq, stripes)
        #: driver seq -> stage intervals harvested with the frame (taken
        #: from the pipe at emit time, under _cond, so the event loop's
        #: pop never touches pipe state the driver thread mutates);
        #: bounded like the pipe's own store
        self._trace_out: dict = {}
        #: pipe seq -> driver seq, recorded per successful submit: a
        #: frame the pipe never accepted has no entry, so its loss can
        #: never shift later results onto wrong driver seqs
        self._seq_map: dict = {}
        self._seq = 0
        self._flush_req = 0                  # flush generation counter
        self._flush_ack = 0
        self._stop = False
        self.frames_dropped_total = 0
        self.encode_errors_total = 0
        self._error_streak = 0
        #: pipe.stats() snapshot maintained by the driver thread — the
        #: event-loop stats() surface must not iterate deques the driver
        #: thread is mutating
        self._stats_cache = dict(pipe.stats())
        self._thread = threading.Thread(
            target=self._run, name="torchenc-async", daemon=True)
        self._thread.start()

    # -- event-loop surface (never blocks) --------------------------------

    @property
    def metrics(self):
        return self._metrics

    @metrics.setter
    def metrics(self, m) -> None:
        # the server attaches its Metrics after construction; the pipe
        # publishes the dispatch/fetch/D2H series, so it gets it too
        self._metrics = m
        self.pipe.metrics = m

    def try_submit(self, frame) -> Optional[int]:
        """Queue one frame for the driver thread; None = dropped (queue
        full — the pipeline is not keeping up, backpressure at the edge
        instead of a stalled event loop).

        A frame tensor on the encoder's device is handed over here, in the
        caller's thread, where its stream is current (the encoder's
        ``adopt``: it only enqueues a stream wait; a tensor on another
        device raises); the driver thread submits it as it is."""
        frame = self.pipe.base.adopt(frame)
        with self._cond:
            if self._stop:
                return None
            if len(self._in_q) >= self.submit_depth:
                self.frames_dropped_total += 1
                if self._metrics is not None:
                    self._metrics.inc_frames_dropped()
                return None
            seq = self._seq
            self._seq += 1
            self._in_q.append((seq, frame))
            self._cond.notify_all()
            return seq

    def submit(self, frame) -> Optional[int]:
        """Alias of :meth:`try_submit` — this facade NEVER blocks the
        caller; a full queue drops (the capture loop's contract)."""
        return self.try_submit(frame)

    def poll(self) -> List[Tuple[int, list]]:
        """Harvest whatever the driver thread completed (pure queue
        drain; ordering follows submission order)."""
        with self._cond:
            out = list(self._out)
            self._out.clear()
        return out

    def flush(self, timeout: float = 60.0) -> List[Tuple[int, list]]:
        """Drain everything submitted so far (deterministic: on return,
        every accepted frame has been harvested or accounted as an
        error). Blocks the caller — warm-up/teardown paths only."""
        with self._cond:
            if not self._thread.is_alive():
                out = list(self._out)
                self._out.clear()
                return out
            self._flush_req += 1
            want = self._flush_req
            self._cond.notify_all()
            self._cond.wait_for(
                lambda: self._flush_ack >= want or self._stop,
                timeout=timeout)
            out = list(self._out)
            self._out.clear()
        return out

    def close(self) -> None:
        """Stop the driver and abandon queued frames (display teardown or
        restart). NEVER blocks the caller: teardown runs on
        the event loop, where a join would stall every display sharing
        it. All cleanup (pipe.close + ring release) happens on the
        driver thread as it exits — releasing the rings from HERE would
        race the thread's current dispatch and defeat the
        staging ring's slot guard. A thread wedged in a dead device
        fetch is abandoned with its (equally abandoned) pipe; a restarted
        display builds a fresh pipeline with a fresh ring either way."""
        with self._cond:
            self._stop = True
            self._in_q.clear()
            self._cond.notify_all()

    def join(self, timeout: Optional[float] = None) -> bool:
        """Wait for the driver thread to exit after :meth:`close` (teardown
        off the event loop: process exit must not find the thread inside
        a device call). True when it has exited."""
        self._thread.join(timeout)
        return not self._thread.is_alive()

    # -- control passthrough ----------------------------------------------

    def force_keyframe(self) -> None:
        self.pipe.force_keyframe()

    @property
    def n_inflight(self) -> int:
        return self.pipe.n_inflight + len(self._in_q)

    def stats(self) -> dict:
        """Pipe gauges plus the driver's own accounting. Reads the driver thread's snapshot of pipe.stats() — calling the
        pipe directly from here would iterate deques the driver thread
        mutates concurrently."""
        with self._cond:
            st = dict(self._stats_cache)
            st["submit_queue_depth"] = len(self._in_q)
        st["frames_dropped"] = (st.get("frames_dropped", 0)
                                + self.frames_dropped_total)
        st["encode_errors"] = self.encode_errors_total
        return st

    def pop_trace(self, seq: int):
        """Stage intervals of a harvested frame, keyed by the driver seq
        ``try_submit`` returned (once; None if unknown)."""
        with self._cond:
            return self._trace_out.pop(seq, None)

    # -- driver thread ------------------------------------------------------

    def _emit(self, results) -> None:
        if not results:
            return
        with self._cond:
            for pipe_seq, stripes in results:
                seq = self._seq_map.pop(pipe_seq, pipe_seq)
                tr = self.pipe.pop_trace(pipe_seq)
                if tr:
                    self._trace_out[seq] = tr
                    while len(self._trace_out) > 4 * self.submit_depth:
                        self._trace_out.pop(next(iter(self._trace_out)))
                self._out.append((seq, stripes))
            # results arrive in pipe order: mappings below the newest
            # emitted pipe seq belong to frames the pipe lost to errors
            # and will never be yielded — drop them so the map stays
            # bounded
            horizon = results[-1][0]
            for k in [k for k in self._seq_map if k < horizon]:
                self._seq_map.pop(k)
            self._cond.notify_all()

    def _harvest(self, flush_partial: bool) -> bool:
        """One non-blocking harvest pass; True if anything completed."""
        if self.faults is not None:
            self.faults.maybe_hang_sync(FETCH_HANG_POINT)
        results = self.pipe.poll(flush_partial=flush_partial)
        self._emit(results)
        return bool(results)

    def _run(self) -> None:
        try:
            while self._run_pass():
                pass
        finally:
            # thread-side cleanup: close() must never block the event
            # loop, so the pipe teardown happens HERE, where the pipe's
            # single-owner discipline makes it race-free
            self._cleanup()

    def _run_pass(self) -> bool:
        """One driver pass; False when the driver is stopping."""
        with self._cond:
            if self._stop:
                return False
            work = list(self._in_q)
            self._in_q.clear()
            flush_want = self._flush_req
        # 1. dispatch every queued frame. pipe.submit may block
        # harvesting the OLDEST batch when the pipe is full — exactly
        # the overlap we want: batches 2..N keep computing while the
        # driver waits on batch 1's fetch. An erroring frame costs
        # ITSELF (counted + reported), never the rest of the pass; a
        # frame the pipe never accepted gets no seq mapping, so its
        # loss cannot shift later results onto wrong seqs.
        for seq, frame in work:
            try:
                pipe_seq = self.pipe._submit(frame)
            except Exception as exc:
                self._count_error(exc)
            else:
                if pipe_seq is not None:
                    with self._cond:
                        self._seq_map[pipe_seq] = seq
        try:
            # 2. harvest whatever is ready (never blocks); ship a partial
            # fetch group as soon as the submit queue runs dry
            with self._cond:
                idle = not self._in_q
            self._harvest(flush_partial=(
                idle and self.flush_partial_when_idle))
            self._error_streak = 0
        except Exception as exc:
            # harvest failure: completed frames stay queued in the
            # pipe's ready list (surfacing next pass); the lost frame's
            # stale seq mapping is pruned at the next emit
            self._count_error(exc)
        # 3. explicit flush: drain the pipe COMPLETELY — a mid-drain
        # error costs its frame (counted) and the drain resumes, so
        # the ack below never strands unharvested frames behind a
        # raising one. Each failed drain removes at least the raising
        # frame, so this terminates.
        if flush_want > self._flush_ack:
            while True:
                try:
                    self._emit(self.pipe.flush())
                    break
                except Exception as exc:
                    self._count_error(exc)
                    if self.pipe.n_inflight == 0 and not self.pipe.n_held:
                        break
        with self._cond:
            self._stats_cache = dict(self.pipe.stats())
            if flush_want > self._flush_ack:
                # flush() returns once everything submitted either
                # completed or was accounted as an error — never strands
                self._flush_ack = flush_want
                self._cond.notify_all()
            if self._stop:
                return False
            if self._in_q or self._flush_req > self._flush_ack:
                return True
            # in-flight work pending: short beat, then re-poll; a forming
            # batch's deadline needs the beat too. Otherwise sleep until
            # new work arrives.
            waiting = self.pipe.n_inflight > 0 or self.pipe.n_held > 0
            self._cond.wait(self.POLL_INTERVAL_S if waiting else 0.25)
        return True

    def _cleanup(self) -> None:
        # pipe.close() owns ring release (it force-releases its staging
        # lane as its last step)
        try:
            self.pipe.close()
        except Exception:
            logger.exception("pipe close raised")

    def _count_error(self, exc: BaseException) -> None:
        """A device/entropy failure costs its frame; it is COUNTED and
        REPORTED to ``on_error``, whose owner decides what follows."""
        self.encode_errors_total += 1
        if self._metrics is not None:
            self._metrics.inc_encode_errors()
        logger.exception("async encode pass failed")
        if self.on_error is not None:
            try:
                self.on_error(exc)
            except Exception:
                logger.exception("on_error hook failed")
        self._error_streak += 1
        # interruptible backoff: close() must not wait out an error storm
        with self._cond:
            if not self._stop:
                self._cond.wait(min(1.0, 0.05 * self._error_streak))

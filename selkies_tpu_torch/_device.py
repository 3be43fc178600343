"""Device resolution for the port's entry points.

Every constructor that owns tensors takes an explicit ``device``. ``None``
means the card: the port runs on CUDA unless the caller asks for the CPU
(the tests do, with ``device="cpu"``). With no card and no device asked
for, construction raises — the port never carries on quietly on the CPU.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, Optional, Tuple, Union

import torch

DeviceLike = Union[str, torch.device, None]

_streams: Dict[torch.device, "torch.cuda.Stream"] = {}
_streams_lock = threading.Lock()


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` → ``cuda`` (or RuntimeError without a card); else as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "selkies_tpu_torch needs a CUDA device; pass device='cpu' "
                "to run the plain PyTorch versions on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is unavailable")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def encoder_stream(device: torch.device) -> "Optional[torch.cuda.Stream]":
    """The one CUDA stream every encoder on ``device`` runs on (``None`` on
    the CPU), made at first use.

    One stream per card, not per encoder: PyTorch's caching allocator hands
    a freed block only to later allocations on the stream it was freed on,
    so blocks freed on a closed encoder's own stream would stay reserved
    for good. On one shared stream they go back to the pool the next
    encoder draws from."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    with _streams_lock:
        stream = _streams.get(device)
        if stream is None:
            stream = torch.cuda.Stream(device=device)
            _streams[device] = stream
        return stream


@contextlib.contextmanager
def on_device(device: torch.device, stream=None):
    """``device`` current and ``stream`` (by default the device's encoder
    stream) its current stream, for the block: every launch, allocation
    and copy made inside goes to that device, whichever device was
    current before. A no-op on the CPU. The lanes of a mesh enter it per
    shard, so a shard's work runs on the shard's device."""
    device = torch.device(device)
    if device.type != "cuda":
        yield
        return
    if stream is None:
        stream = encoder_stream(device)
    with torch.cuda.device(device), torch.cuda.stream(stream):
        yield


def adopt_frame(frame: torch.Tensor, device: torch.device,
                stream: "Optional[torch.cuda.Stream]") -> torch.Tensor:
    """Take over a uint8 frame tensor (or a stacked batch of frames) that
    a caller made on ``device``, for an encoder that works on ``stream``
    (its device's encoder stream; ``None`` on the CPU).

    A tensor on another device, or of another type, raises ``ValueError``:
    nothing is copied behind the caller's back. On the card the caller
    wrote the frame on its current stream, while the encoder reads it on
    ``stream``; so ``stream`` waits for the work queued so far on the
    caller's stream, and the frame's memory is marked as in use on
    ``stream`` (``record_stream``), so that the caching allocator does not
    hand it to a later allocation before the encoder's reads are done.
    Call it from the thread that made the frame: the current stream is
    per thread. Both steps only enqueue; neither waits for the device."""
    if frame.device != torch.device(device):
        raise ValueError(f"frame tensor on {frame.device}; the encoder "
                         f"runs on {device}")
    if frame.dtype != torch.uint8:
        raise ValueError(f"frame tensor of {frame.dtype}; uint8 expected")
    if stream is not None:
        stream.wait_stream(torch.cuda.current_stream(frame.device))
        frame.record_stream(stream)
    return frame


#: seconds between two anchors of a device clock: a harvest re-anchors at
#: most this often, so the card's timer and ``CLOCK_MONOTONIC`` cannot drift
#: apart over a long run
ANCHOR_EVERY_S = 1.0
#: the widest host bracket (from the record to its observed completion) an
#: anchor may have; a wider one is discarded and the previous anchor kept
ANCHOR_BRACKET_S = 2e-4

_clocks: Dict[torch.device, "DeviceClock"] = {}
_clocks_lock = threading.Lock()


class DeviceClock:
    """Timing events of one card on the host's ``time.monotonic()`` clock.

    CUDA timing events measure only against each other, on the card's own
    timer. An *anchor* is a timing event whose host time is known: it is
    recorded on a stream of its own that nothing else uses (so it runs at
    once, whatever the encoder streams are doing), and the host clock is
    read just before the record and just after its completion; the anchor
    stands at the middle of that bracket. Any later event of the card
    stands at the anchor's host time plus the elapsed time between the two.

    Made (after a synchronize of the card) when the first lane of the card
    is built; :meth:`refresh`, called at each harvest, takes a new anchor
    at most every ``ANCHOR_EVERY_S``."""

    def __init__(self, device: torch.device) -> None:
        self.device = torch.device(device)
        # a high-priority stream: never one of the pooled normal-priority
        # streams the encoders run on
        self.stream = torch.cuda.Stream(device=self.device, priority=-1)
        self.anchor: Optional[tuple] = None
        self._anchored_at = 0.0
        torch.cuda.synchronize(self.device)
        for _ in range(3):
            self._take()

    def _take(self) -> None:
        ev = torch.cuda.Event(enable_timing=True)
        t0 = time.monotonic()
        ev.record(self.stream)
        ev.synchronize()
        t1 = time.monotonic()
        self._anchored_at = t1
        if self.anchor is None or t1 - t0 <= ANCHOR_BRACKET_S:
            self.anchor = (ev, 0.5 * (t0 + t1))

    def refresh(self) -> None:
        """A new anchor if the last was taken ``ANCHOR_EVERY_S`` ago."""
        if time.monotonic() - self._anchored_at >= ANCHOR_EVERY_S:
            self._take()

    def record(self, stream) -> tuple:
        """A timing event recorded on ``stream`` now, with the anchor to
        read it against (taken before it, so their distance is >= 0)."""
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(stream)
        return ev, self.anchor

    @staticmethod
    def host_time(event, anchor: tuple) -> float:
        """``event``'s completion on the host clock (both completed)."""
        ev, t = anchor
        return t + ev.elapsed_time(event) / 1e3


def device_clock(device: torch.device) -> DeviceClock:
    """The one :class:`DeviceClock` of a card, made at first use."""
    device = torch.device(device)
    with _clocks_lock:
        clock = _clocks.get(device)
        if clock is None:
            clock = _clocks[device] = DeviceClock(device)
        return clock


class TickClock:
    """A lane tick's device interval on the host clock: from the first
    shard's start (a timing event recorded on each shard's stream when the
    tick's dispatch begins) to the last shard's completion (a timing event
    recorded on each shard's stream after its prefix copy). Without a card
    it stamps nothing and reads None."""

    def __init__(self, shards) -> None:
        #: (clock, stream) per shard, in shard order
        self._shards = [(device_clock(sh.device), sh.stream)
                        for sh in shards if sh.stream is not None]

    def stamp(self) -> Optional[list]:
        """A timing event on every shard's stream now, each with its
        card's anchor: a tick's start, or its completion."""
        return [c.record(s) for c, s in self._shards] or None

    def interval(self, starts, ends) -> Optional[Tuple[float, float]]:
        """The tick's (start, completion) on the host clock, from its
        :meth:`stamp` lists (all completed: call after the harvest); then
        refresh the anchors."""
        if not starts or not ends:
            return None
        t0 = min(DeviceClock.host_time(ev, a) for ev, a in starts)
        t1 = max(DeviceClock.host_time(ev, a) for ev, a in ends)
        for clock, _s in self._shards:
            clock.refresh()
        return t0, t1

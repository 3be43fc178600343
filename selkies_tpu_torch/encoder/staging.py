"""Host/device transfers of the encoders: the host-to-device staging ring
(counterpart of ``StagingRing``/``StagingTicket`` in
``selkies_tpu/encoder/h264_device.py``), :class:`SlotUploads`, which puts
host frames into the slots of a lane's device batch, and
:class:`HostCopy`, the device-to-host copy that stands in for JAX's
``copy_to_host_async``.

The JAX ring donates device buffers so an upload can overlap the previous
frame's encode. PyTorch has no donation; the port gets the same overlap
from preallocated slots, each a pinned host buffer plus a device buffer of
the frame's shape:

* ``stage`` copies the host frame into a free slot's pinned buffer, starts a
  ``non_blocking`` copy to the slot's device buffer on the caller's stream,
  and records a CUDA event after it;
* a slot is busy from ``stage`` until its ticket is released (the frame was
  harvested), and it is written again only after its event has completed,
  so the host never overwrites pinned memory a copy is still reading. The
  device buffer needs no such guard: every read and write of it is queued
  on the one pipeline stream, in order;
* with every slot busy, ``stage`` falls back to a fresh, unmanaged upload
  (counted in ``stalls_total``): correctness never depends on the caller
  sizing the ring right, only the overlap does.

On the CPU (``device="cpu"``, the tests) a slot is one host tensor and
there are no events.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch


class StagingRing:
    def __init__(self, depth: int = 2, device=None) -> None:
        self.depth = max(2, int(depth))
        self.device = torch.device(device) if device is not None \
            else torch.device("cpu")
        self._cuda = self.device.type == "cuda"
        self._host: List[Optional[torch.Tensor]] = [None] * self.depth
        self._dev: List[Optional[torch.Tensor]] = [None] * self.depth
        self._events: List[Optional[torch.cuda.Event]] = [None] * self.depth
        self._busy = [False] * self.depth
        self._shape: Optional[Tuple[int, ...]] = None
        self._next = 0
        #: lane generation: tickets carry it so a ticket issued before a
        #: shape change can never free the new lane's same-index slot
        self._generation = 0
        self.stalls_total = 0
        self.staged_total = 0

    @property
    def in_use(self) -> int:
        return sum(self._busy)

    def _restart(self, shape) -> None:
        self._shape = shape
        self._host = [None] * self.depth
        self._dev = [None] * self.depth
        self._events = [None] * self.depth
        self._busy = [False] * self.depth
        self._next = 0
        self._generation += 1

    def stage(self, frame: np.ndarray, stream=None
              ) -> "tuple[torch.Tensor, Optional[tuple]]":
        """Stage one host uint8 frame; returns (device tensor, ticket).

        ticket is None when the ring stalled (every slot still held) and a
        fresh buffer was uploaded instead. Release the ticket with
        :meth:`release` once the frame has been harvested."""
        frame = np.ascontiguousarray(frame)
        if tuple(frame.shape) != self._shape:
            # geometry change: abandon the old slots and restart the lane
            self._restart(tuple(frame.shape))
        idx = self._next
        s = None
        if self._cuda:
            s = stream if stream is not None else \
                torch.cuda.current_stream(self.device)
        if self._busy[idx]:
            free = next((i for i in range(self.depth)
                         if not self._busy[i]), None)
            if free is None:
                self.stalls_total += 1
                if s is None:
                    return torch.from_numpy(frame.copy()), None
                with torch.cuda.stream(s):
                    return torch.from_numpy(frame).to(self.device), None
            idx = free
        src = torch.from_numpy(frame)
        if not self._cuda:
            if self._dev[idx] is None:
                self._dev[idx] = torch.empty(src.shape, dtype=src.dtype)
            self._dev[idx].copy_(src)
        else:
            if self._host[idx] is None:
                self._host[idx] = torch.empty(src.shape, dtype=src.dtype,
                                              pin_memory=True)
                self._dev[idx] = torch.empty(src.shape, dtype=src.dtype,
                                             device=self.device)
                self._events[idx] = torch.cuda.Event()
            else:
                # the previous upload from this pinned buffer must have
                # landed before the host writes it again
                self._events[idx].synchronize()
            self._host[idx].copy_(src)
            with torch.cuda.stream(s):
                self._dev[idx].copy_(self._host[idx], non_blocking=True)
                self._events[idx].record(s)
        self._busy[idx] = True
        self._next = (idx + 1) % self.depth
        self.staged_total += 1
        return self._dev[idx], (self._generation, idx)

    def release(self, ticket: "Optional[tuple]") -> None:
        """Mark a slot's contents consumed. Tickets from a retired lane
        (issued before a shape change) are no-ops."""
        if ticket is not None:
            gen, idx = ticket
            if gen == self._generation:
                self._busy[idx] = False

    def release_all(self) -> None:
        """Teardown: a closed pipeline holds no live readers."""
        self._busy = [False] * self.depth


class StagingTicket:
    """Refcounted handle on one staged slot: released after the last frame
    that reads it has been harvested."""

    __slots__ = ("_ring", "_ticket", "_refs")

    def __init__(self, ring: StagingRing, ticket: "Optional[tuple]",
                 refs: int = 1) -> None:
        self._ring = ring
        self._ticket = ticket
        self._refs = refs

    def release(self) -> None:
        self._refs -= 1
        if self._refs <= 0 and self._ticket is not None:
            self._ring.release(self._ticket)
            self._ticket = None


class HostCopy:
    """One device-to-host copy in flight: a pinned host tensor, filled by a
    ``non_blocking`` copy on the encoder's stream, and the event recorded
    after it. On the CPU (``stream`` None) the "copy" is the tensor itself
    and is done."""

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


def pad_into(dst: np.ndarray, frame: np.ndarray) -> None:
    """Write ``frame`` [h, w, 3] into ``dst`` [H, W, 3] (H >= h, W >= w)
    with the edge replicated into the pad (``np.pad(mode="edge")``),
    without an intermediate padded copy."""
    h, w = frame.shape[:2]
    dst[:h, :w] = frame
    if h < dst.shape[0]:
        dst[h:, :w] = frame[h - 1]
    if w < dst.shape[1]:
        dst[:, w:] = dst[:, w - 1:w]


class SlotUploads:
    """Host frames into slots of a device batch ``[N, H, W, 3]``.

    On the card each upload goes through one of ``depth`` pinned host
    batches, in turn, with a ``non_blocking`` copy per slot on the given
    stream and an event after them; a pinned batch is written again only
    after its last copies have landed, so the host never overwrites memory
    a copy still reads. The device batch needs no guard: a lane's steps
    and uploads are all queued on one stream, in order. On the CPU a slot
    is written directly."""

    def __init__(self, shape, depth: int, device) -> None:
        self.shape = tuple(shape)
        self.depth = max(1, int(depth))
        self.device = torch.device(device)
        self._host: List[Optional[torch.Tensor]] = [None] * self.depth
        self._events: List[Optional["torch.cuda.Event"]] = \
            [None] * self.depth
        self._next = 0
        #: bytes copied host to device (observability)
        self.bytes_total = 0

    def upload(self, dst: torch.Tensor, frames, stream=None) -> None:
        """``frames``: slot index -> host uint8 frame (padded to the slot
        here if smaller)."""
        if not frames:
            return
        if self.device.type != "cuda":
            for n, f in frames.items():
                pad_into(dst[n].numpy(), np.asarray(f, np.uint8))
            self.bytes_total += sum(dst[n].numel() for n in frames)
            return
        k = self._next
        self._next = (k + 1) % self.depth
        if self._host[k] is None:
            self._host[k] = torch.empty(self.shape, dtype=torch.uint8,
                                        pin_memory=True)
            self._events[k] = torch.cuda.Event()
        else:
            self._events[k].synchronize()
        host = self._host[k]
        view = host.numpy()
        for n, f in frames.items():
            pad_into(view[n], np.asarray(f, np.uint8))
        with torch.cuda.stream(stream):
            for n in frames:
                dst[n].copy_(host[n], non_blocking=True)
            self._events[k].record(stream)
        self.bytes_total += sum(dst[n].numel() for n in frames)

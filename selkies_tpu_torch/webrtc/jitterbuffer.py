"""Receive-side jitter buffer: reorder, loss detection, frame assembly.

Role parity with the vendored ``src/selkies/webrtc/jitterbuffer.py``
(SURVEY.md §2.4): RTP packets arrive out of order; the buffer re-sequences
them, surfaces contiguous runs to the depayloader, and reports gaps for
NACK generation.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from .rtp import RtpPacket, unwrap_seq


@dataclass
class JitterFrame:
    payloads: List[RtpPacket]
    timestamp: int


class JitterBuffer:
    def __init__(self, capacity: int = 512):
        self.capacity = capacity
        self._packets: Dict[int, RtpPacket] = {}    # unwrapped seq -> packet
        self._last_unwrapped = -1                    # highest seen
        self._next = -1                              # next seq to release

    @property
    def pending(self) -> int:
        return len(self._packets)

    def missing(self) -> List[int]:
        """Sequence numbers (u16) between the release head and the highest
        received packet that have not arrived — NACK candidates."""
        if self._next < 0:
            return []
        return [s & 0xFFFF for s in range(self._next, self._last_unwrapped)
                if s not in self._packets]

    def add(self, packet: RtpPacket) -> List[RtpPacket]:
        """Insert one packet; returns the in-order run now releasable."""
        seq = unwrap_seq(self._last_unwrapped, packet.sequence_number)
        if seq > self._last_unwrapped:
            self._last_unwrapped = seq
        if self._next < 0:
            self._next = seq
        if seq < self._next:                 # too late — already released past
            return []
        self._packets[seq] = packet
        if len(self._packets) > self.capacity:
            # overflow: jump the release head to the oldest held packet
            self._next = max(self._next, min(self._packets))
        out: List[RtpPacket] = []
        while self._next in self._packets:
            out.append(self._packets.pop(self._next))
            self._next += 1
        return out

    def skip_all(self) -> None:
        """Abandon every gap up to the highest packet seen (burst-loss
        resync: the next keyframe restarts decoding)."""
        self._packets.clear()
        if self._last_unwrapped >= 0:
            self._next = self._last_unwrapped + 1

    def skip_to(self, seq_u16: int) -> None:
        """Abandon everything before seq (keyframe resync after loss)."""
        seq = unwrap_seq(self._last_unwrapped, seq_u16)
        for s in [s for s in self._packets if s < seq]:
            del self._packets[s]
        if self._next < seq:
            self._next = seq

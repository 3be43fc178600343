"""H.264 RTP payloader/depayloader (RFC 6184, non-interleaved mode).

Carries the encoder's H.264 bitstream over RTP *without re-encoding* — the
exact role the reference stages its vendored aiortc for (SURVEY.md §2.4
"externally encoded H.264 → packetizer without re-encode";
``src/selkies/webrtc/codecs/h264.py`` consumed at ref ``h264.py:157``).

Annex-B access units split into NAL units; NALs ≤ MTU ship as single NAL
packets, small ones may aggregate into STAP-A, large ones fragment into
FU-A. Depacketization reassembles Annex-B access units keyed on the RTP
marker bit.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, List, Optional

from .rtp import RtpPacket

NAL_STAP_A = 24
NAL_FU_A = 28

ANNEXB_3 = b"\x00\x00\x01"
ANNEXB_4 = b"\x00\x00\x00\x01"


def split_annexb(data: bytes) -> List[bytes]:
    """Split an Annex-B stream into raw NAL units (start codes removed)."""
    out: List[bytes] = []
    i = 0
    n = len(data)
    # find first start code
    start = None
    while i + 3 <= n:
        if data[i:i + 3] == ANNEXB_3:
            start = i + 3
            i += 3
            break
        i += 1
    if start is None:
        return [data] if data else []
    while i + 3 <= n:
        if data[i:i + 3] == ANNEXB_3:
            end = i - 1 if i > 0 and data[i - 1] == 0 else i
            if end > start:
                out.append(data[start:end])
            start = i + 3
            i += 3
        else:
            i += 1
    if start < n:
        out.append(data[start:])
    return [x for x in out if x]


class H264Payloader:
    """Annex-B access unit → RTP payloads (same timestamp, marker on last)."""

    def __init__(self, mtu: int = 1200):
        self.mtu = mtu

    def payloads(self, access_unit: bytes) -> List[bytes]:
        nals = split_annexb(access_unit)
        out: List[bytes] = []
        agg: List[bytes] = []
        agg_size = 0

        def flush_agg():
            nonlocal agg, agg_size
            if not agg:
                return
            if len(agg) == 1:
                out.append(agg[0])
            else:
                nri = max((n[0] >> 5) & 3 for n in agg)
                pkt = bytearray([(nri << 5) | NAL_STAP_A])
                for n in agg:
                    pkt += len(n).to_bytes(2, "big") + n
                out.append(bytes(pkt))
            agg, agg_size = [], 0

        for nal in nals:
            if len(nal) <= self.mtu:
                if agg_size + len(nal) + 3 > self.mtu:
                    flush_agg()
                agg.append(nal)
                agg_size += len(nal) + 2 + 1
                continue
            flush_agg()
            # FU-A fragmentation
            hdr = nal[0]
            nri = (hdr >> 5) & 3
            ntype = hdr & 0x1F
            payload = nal[1:]
            pos = 0
            first = True
            chunk = self.mtu - 2
            while pos < len(payload):
                piece = payload[pos:pos + chunk]
                pos += len(piece)
                fu_ind = (nri << 5) | NAL_FU_A
                fu_hdr = ntype | (0x80 if first else 0) \
                    | (0x40 if pos >= len(payload) else 0)
                out.append(bytes([fu_ind, fu_hdr]) + piece)
                first = False
        flush_agg()
        return out

    def packetize(
        self, access_unit: bytes, ssrc: int, payload_type: int,
        sequence_number: int, timestamp: int,
    ) -> List[RtpPacket]:
        payloads = self.payloads(access_unit)
        pkts = []
        for i, p in enumerate(payloads):
            pkts.append(RtpPacket(
                payload_type=payload_type,
                sequence_number=(sequence_number + i) & 0xFFFF,
                timestamp=timestamp & 0xFFFFFFFF,
                ssrc=ssrc,
                payload=p,
                marker=1 if i == len(payloads) - 1 else 0,
            ))
        return pkts


@dataclass
class _FuState:
    header: int = 0
    data: bytearray = None  # type: ignore[assignment]


class H264Depayloader:
    """RTP payloads → Annex-B access units.

    Feed packets in sequence order; an access unit is returned when the
    marker-bit packet lands. Mid-FU loss drops the fragmented NAL only.
    """

    def __init__(self):
        self._nals: List[bytes] = []
        self._fu: Optional[_FuState] = None
        self._last_seq: Optional[int] = None

    def feed(self, packet: RtpPacket) -> Optional[bytes]:
        p = packet.payload
        if not p:
            return None
        # a sequence gap invalidates any FU-A reassembly in progress —
        # emitting a spliced NAL would hand the decoder corrupt slices
        if self._last_seq is not None and \
                packet.sequence_number != (self._last_seq + 1) & 0xFFFF:
            self._fu = None
        self._last_seq = packet.sequence_number
        ntype = p[0] & 0x1F
        if ntype == NAL_STAP_A:
            pos = 1
            while pos + 2 <= len(p):
                ln = int.from_bytes(p[pos:pos + 2], "big")
                pos += 2
                self._nals.append(p[pos:pos + ln])
                pos += ln
        elif ntype == NAL_FU_A:
            if len(p) < 2:
                return None
            fu_hdr = p[1]
            start, end = fu_hdr & 0x80, fu_hdr & 0x40
            if start:
                nal_hdr = (p[0] & 0xE0) | (fu_hdr & 0x1F)
                self._fu = _FuState(nal_hdr, bytearray([nal_hdr]) )
                self._fu.data += p[2:]
            elif self._fu is not None:
                self._fu.data += p[2:]
            if end and self._fu is not None:
                self._nals.append(bytes(self._fu.data))
                self._fu = None
        else:
            self._nals.append(p)

        if packet.marker:
            au = b"".join(ANNEXB_4 + n for n in self._nals)
            self._nals = []
            self._fu = None
            return au
        return None

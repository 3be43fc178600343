"""RTP and RTCP packet codecs.

Wire formats per RFC 3550 (RTP/SR/RR/SDES/BYE), RFC 4585 (PLI/NACK), RFC
5104 (FIR), draft-holmer-rmcat-transport-wide-cc-extensions-01 (TWCC
feedback), and draft-alvestrand-rmcat-remb (REMB). Role parity with the
reference's vendored ``src/selkies/webrtc/rtp.py`` (SURVEY.md §2.4) —
re-designed, not translated: plain dataclasses + struct packing, no GObject.

Header extensions supported (two-byte forms are not needed by the browser
peers we target): abs-send-time, transport-wide sequence number, and the
playout-delay extension the reference injects in
``legacy/gstwebrtc_app.py:1744-1780``.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

RTP_VERSION = 2
RTP_HEADER_LEN = 12

# RTCP packet types
RTCP_SR = 200
RTCP_RR = 201
RTCP_SDES = 202
RTCP_BYE = 203
RTCP_RTPFB = 205   # transport-layer feedback (NACK=1, TWCC=15)
RTCP_PSFB = 206    # payload-specific feedback (PLI=1, FIR=4, REMB=15)


def unwrap_seq(last_unwrapped: int, seq: int) -> int:
    """Extend a u16 sequence number into a monotone int (nearest wrap)."""
    if last_unwrapped < 0:
        return seq
    last16 = last_unwrapped & 0xFFFF
    delta = ((seq - last16 + 0x8000) & 0xFFFF) - 0x8000
    return last_unwrapped + delta


@dataclass
class RtpPacket:
    payload_type: int = 0
    sequence_number: int = 0
    timestamp: int = 0
    ssrc: int = 0
    payload: bytes = b""
    marker: int = 0
    csrc: List[int] = field(default_factory=list)
    extensions: Dict[int, bytes] = field(default_factory=dict)  # id -> data
    padding: int = 0

    def serialize(self, extension_profile: int = 0xBEDE) -> bytes:
        has_ext = bool(self.extensions)
        b0 = (RTP_VERSION << 6) | ((1 if self.padding else 0) << 5) \
            | ((1 if has_ext else 0) << 4) | len(self.csrc)
        b1 = (self.marker << 7) | self.payload_type
        out = bytearray(struct.pack(
            "!BBHII", b0, b1, self.sequence_number & 0xFFFF,
            self.timestamp & 0xFFFFFFFF, self.ssrc))
        for c in self.csrc:
            out += struct.pack("!I", c)
        if has_ext:
            body = bytearray()
            for ext_id, data in sorted(self.extensions.items()):
                if not 1 <= ext_id <= 14:
                    raise ValueError("one-byte extension id must be 1-14")
                if not 1 <= len(data) <= 16:
                    raise ValueError("one-byte extension length must be 1-16")
                body.append((ext_id << 4) | (len(data) - 1))
                body += data
            while len(body) % 4:
                body.append(0)
            out += struct.pack("!HH", extension_profile, len(body) // 4)
            out += body
        out += self.payload
        if self.padding:
            out += b"\x00" * (self.padding - 1) + bytes([self.padding])
        return bytes(out)

    @classmethod
    def parse(cls, data: bytes) -> "RtpPacket":
        if len(data) < RTP_HEADER_LEN:
            raise ValueError("RTP packet too short")
        b0, b1, seq, ts, ssrc = struct.unpack_from("!BBHII", data)
        if b0 >> 6 != RTP_VERSION:
            raise ValueError("bad RTP version")
        cc = b0 & 0x0F
        has_pad = (b0 >> 5) & 1
        has_ext = (b0 >> 4) & 1
        pos = RTP_HEADER_LEN
        csrc = []
        for _ in range(cc):
            (c,) = struct.unpack_from("!I", data, pos)
            csrc.append(c)
            pos += 4
        extensions: Dict[int, bytes] = {}
        if has_ext:
            profile, words = struct.unpack_from("!HH", data, pos)
            pos += 4
            ext_end = pos + words * 4
            if profile == 0xBEDE:  # one-byte header extensions
                p = pos
                while p < ext_end:
                    hdr = data[p]
                    p += 1
                    if hdr == 0:
                        continue
                    ext_id, ln = hdr >> 4, (hdr & 0x0F) + 1
                    if ext_id == 15:
                        break
                    extensions[ext_id] = data[p:p + ln]
                    p += ln
            pos = ext_end
        end = len(data)
        padding = 0
        if has_pad and end > pos:
            padding = data[-1]
            end -= padding
        return cls(
            payload_type=b1 & 0x7F, marker=b1 >> 7, sequence_number=seq,
            timestamp=ts, ssrc=ssrc, csrc=csrc, extensions=extensions,
            payload=data[pos:end], padding=padding)


def is_rtcp(data: bytes) -> bool:
    """Demux RTCP from RTP on one socket (RFC 5761 packet-type ranges)."""
    return len(data) >= 2 and 200 <= data[1] <= 206


# ------------------------------------------------------------------ RTCP


@dataclass
class ReceiverReport:
    ssrc: int
    fraction_lost: int = 0
    packets_lost: int = 0
    highest_sequence: int = 0
    jitter: int = 0
    lsr: int = 0
    dlsr: int = 0

    def serialize(self) -> bytes:
        lost = self.packets_lost & 0xFFFFFF
        return struct.pack(
            "!IIIIII", self.ssrc,
            ((self.fraction_lost & 0xFF) << 24) | lost,
            self.highest_sequence & 0xFFFFFFFF, self.jitter,
            self.lsr, self.dlsr)

    @classmethod
    def parse(cls, data: bytes) -> "ReceiverReport":
        ssrc, fl_lost, hseq, jitter, lsr, dlsr = struct.unpack_from("!IIIIII", data)
        lost = fl_lost & 0xFFFFFF
        if lost & 0x800000:
            lost -= 0x1000000
        return cls(ssrc, fl_lost >> 24, lost, hseq, jitter, lsr, dlsr)


@dataclass
class RtcpSenderReport:
    ssrc: int
    ntp_time: int = 0          # 64-bit NTP
    rtp_time: int = 0
    packet_count: int = 0
    octet_count: int = 0
    reports: List[ReceiverReport] = field(default_factory=list)

    def serialize(self) -> bytes:
        body = struct.pack(
            "!IQIII", self.ssrc, self.ntp_time, self.rtp_time & 0xFFFFFFFF,
            self.packet_count, self.octet_count)
        for r in self.reports:
            body += r.serialize()
        return _rtcp_header(RTCP_SR, len(self.reports), body) + body

    @classmethod
    def parse(cls, body: bytes, count: int) -> "RtcpSenderReport":
        ssrc, ntp, rtp_t, pc, oc = struct.unpack_from("!IQIII", body)
        reports = [ReceiverReport.parse(body[24 + i * 24:]) for i in range(count)]
        return cls(ssrc, ntp, rtp_t, pc, oc, reports)


@dataclass
class RtcpReceiverReport:
    ssrc: int
    reports: List[ReceiverReport] = field(default_factory=list)

    def serialize(self) -> bytes:
        body = struct.pack("!I", self.ssrc)
        for r in self.reports:
            body += r.serialize()
        return _rtcp_header(RTCP_RR, len(self.reports), body) + body

    @classmethod
    def parse(cls, body: bytes, count: int) -> "RtcpReceiverReport":
        (ssrc,) = struct.unpack_from("!I", body)
        reports = [ReceiverReport.parse(body[4 + i * 24:]) for i in range(count)]
        return cls(ssrc, reports)


@dataclass
class RtcpSdes:
    items: List[Tuple[int, str]] = field(default_factory=list)  # (ssrc, cname)

    def serialize(self) -> bytes:
        body = b""
        for ssrc, cname in self.items:
            chunk = struct.pack("!I", ssrc) + bytes([1, len(cname)]) + cname.encode()
            chunk += b"\x00"  # item-list terminator
            while len(chunk) % 4:
                chunk += b"\x00"
            body += chunk
        return _rtcp_header(RTCP_SDES, len(self.items), body) + body

    @classmethod
    def parse(cls, body: bytes, count: int) -> "RtcpSdes":
        items = []
        pos = 0
        for _ in range(count):
            (ssrc,) = struct.unpack_from("!I", body, pos)
            pos += 4
            cname = ""
            while pos < len(body) and body[pos] != 0:
                t, ln = body[pos], body[pos + 1]
                val = body[pos + 2:pos + 2 + ln]
                if t == 1:
                    cname = val.decode(errors="replace")
                pos += 2 + ln
            # one terminator octet, then pad the CHUNK to a 32-bit boundary
            pos += 1
            pos = (pos + 3) & ~3
            items.append((ssrc, cname))
        return cls(items)


@dataclass
class RtcpBye:
    sources: List[int] = field(default_factory=list)

    def serialize(self) -> bytes:
        body = b"".join(struct.pack("!I", s) for s in self.sources)
        return _rtcp_header(RTCP_BYE, len(self.sources), body) + body

    @classmethod
    def parse(cls, body: bytes, count: int) -> "RtcpBye":
        return cls([struct.unpack_from("!I", body, i * 4)[0] for i in range(count)])


@dataclass
class RtcpPli:
    sender_ssrc: int
    media_ssrc: int

    def serialize(self) -> bytes:
        body = struct.pack("!II", self.sender_ssrc, self.media_ssrc)
        return _rtcp_header(RTCP_PSFB, 1, body) + body


@dataclass
class RtcpFir:
    sender_ssrc: int
    media_ssrc: int
    seq: int

    def serialize(self) -> bytes:
        body = struct.pack("!II", self.sender_ssrc, 0)
        body += struct.pack("!IBBH", self.media_ssrc, self.seq & 0xFF, 0, 0)
        return _rtcp_header(RTCP_PSFB, 4, body) + body


@dataclass
class RtcpNack:
    sender_ssrc: int
    media_ssrc: int
    lost: List[int] = field(default_factory=list)   # sequence numbers

    def serialize(self) -> bytes:
        fci = b""
        lost = sorted(set(s & 0xFFFF for s in self.lost))
        i = 0
        while i < len(lost):
            pid = lost[i]
            blp = 0
            j = i + 1
            while j < len(lost) and 0 < ((lost[j] - pid) & 0xFFFF) <= 16:
                blp |= 1 << (((lost[j] - pid) & 0xFFFF) - 1)
                j += 1
            fci += struct.pack("!HH", pid, blp)
            i = j
        body = struct.pack("!II", self.sender_ssrc, self.media_ssrc) + fci
        return _rtcp_header(RTCP_RTPFB, 1, body) + body

    @classmethod
    def parse(cls, body: bytes) -> "RtcpNack":
        sender, media = struct.unpack_from("!II", body)
        lost = []
        pos = 8
        while pos + 4 <= len(body):
            pid, blp = struct.unpack_from("!HH", body, pos)
            lost.append(pid)
            for bit in range(16):
                if blp & (1 << bit):
                    lost.append((pid + bit + 1) & 0xFFFF)
            pos += 4
        return cls(sender, media, lost)


@dataclass
class RtcpRemb:
    sender_ssrc: int
    bitrate: int
    ssrcs: List[int] = field(default_factory=list)

    def serialize(self) -> bytes:
        exponent = 0
        mantissa = self.bitrate
        while mantissa > 0x3FFFF:
            mantissa >>= 1
            exponent += 1
        body = struct.pack("!II", self.sender_ssrc, 0)
        body += b"REMB" + bytes([len(self.ssrcs)])
        body += struct.pack("!I", (exponent << 18) | mantissa)[1:]  # 3 bytes
        for s in self.ssrcs:
            body += struct.pack("!I", s)
        return _rtcp_header(RTCP_PSFB, 15, body) + body

    @classmethod
    def parse(cls, body: bytes) -> "RtcpRemb":
        sender, _ = struct.unpack_from("!II", body)
        if body[8:12] != b"REMB":
            raise ValueError("not a REMB packet")
        num = body[12]
        b = struct.unpack("!I", b"\x00" + body[13:16])[0]
        exponent = b >> 18
        mantissa = b & 0x3FFFF
        ssrcs = [struct.unpack_from("!I", body, 16 + i * 4)[0] for i in range(num)]
        return cls(sender, mantissa << exponent, ssrcs)


# TWCC feedback (draft-holmer-rmcat-transport-wide-cc-extensions-01 §3.1)

TWCC_SYMBOL_NOT_RECEIVED = 0
TWCC_SYMBOL_SMALL_DELTA = 1
TWCC_SYMBOL_LARGE_DELTA = 2


@dataclass
class RtcpTwcc:
    sender_ssrc: int
    media_ssrc: int
    base_seq: int
    fb_count: int
    ref_time: int                       # multiples of 64 ms
    received: List[Tuple[int, Optional[int]]] = field(default_factory=list)
    # (seq, recv_time_us or None) — consecutive from base_seq

    def serialize(self) -> bytes:
        symbols: List[int] = []
        deltas = b""
        prev_time: Optional[int] = self.ref_time * 64000
        for _seq, t in self.received:
            if t is None:
                symbols.append(TWCC_SYMBOL_NOT_RECEIVED)
                continue
            delta = (t - prev_time) // 250
            if 0 <= delta <= 255:
                symbols.append(TWCC_SYMBOL_SMALL_DELTA)
                deltas += bytes([delta])
            else:
                delta = max(-32768, min(32767, delta))
                symbols.append(TWCC_SYMBOL_LARGE_DELTA)
                deltas += struct.pack("!h", delta)
            # advance by the value actually encoded, as the parser will
            prev_time = prev_time + delta * 250
        # encode all symbols as two-bit status vector chunks (7 per chunk)
        chunks = b""
        for i in range(0, len(symbols), 7):
            group = symbols[i:i + 7]
            val = 0xC000  # vector chunk, two-bit symbols
            for j, s in enumerate(group):
                val |= s << (12 - 2 * j)
            chunks += struct.pack("!H", val)
        body = struct.pack("!II", self.sender_ssrc, self.media_ssrc)
        body += struct.pack("!HH", self.base_seq & 0xFFFF, len(self.received))
        body += struct.pack("!I", ((self.ref_time & 0xFFFFFF) << 8)
                            | (self.fb_count & 0xFF))
        body += chunks + deltas
        body += b"\x00" * ((-len(body)) % 4)  # FCI zero-padding to 32 bits
        return _rtcp_header(RTCP_RTPFB, 15, body) + body

    @classmethod
    def parse(cls, body: bytes) -> "RtcpTwcc":
        sender, media = struct.unpack_from("!II", body)
        base_seq, count = struct.unpack_from("!HH", body, 8)
        (word,) = struct.unpack_from("!I", body, 12)
        ref_time = word >> 8
        if ref_time & 0x800000:
            ref_time -= 0x1000000
        fb_count = word & 0xFF
        pos = 16
        symbols: List[int] = []
        while len(symbols) < count:
            (chunk,) = struct.unpack_from("!H", body, pos)
            pos += 2
            if chunk & 0x8000:  # status vector
                two_bit = chunk & 0x4000
                n = 7 if two_bit else 14
                for j in range(n):
                    if two_bit:
                        symbols.append((chunk >> (12 - 2 * j)) & 0x3)
                    else:
                        symbols.append((chunk >> (13 - j)) & 0x1)
            else:  # run-length
                symbol = (chunk >> 13) & 0x3
                run = chunk & 0x1FFF
                symbols.extend([symbol] * run)
        symbols = symbols[:count]
        received: List[Tuple[int, Optional[int]]] = []
        t = ref_time * 64000
        for i, s in enumerate(symbols):
            seq = (base_seq + i) & 0xFFFF
            if s == TWCC_SYMBOL_NOT_RECEIVED:
                received.append((seq, None))
                continue
            if s == TWCC_SYMBOL_SMALL_DELTA:
                delta = body[pos]
                pos += 1
            else:
                (delta,) = struct.unpack_from("!h", body, pos)
                pos += 2
            t += delta * 250
            received.append((seq, t))
        return cls(sender, media, base_seq, fb_count, ref_time, received)


def _rtcp_header(pt: int, count: int, body: bytes) -> bytes:
    length = (len(body) + 3) // 4  # in 32-bit words minus one (header incl.)
    pad = (-len(body)) % 4
    if pad:
        raise ValueError("RTCP body must be 32-bit aligned")
    return struct.pack("!BBH", (RTP_VERSION << 6) | count, pt, length)


def parse_rtcp(data: bytes) -> List[object]:
    """Parse a compound RTCP packet into typed packets (unknown ones skipped)."""
    out: List[object] = []
    pos = 0
    while pos + 4 <= len(data):
        b0, pt, length = struct.unpack_from("!BBH", data, pos)
        count = b0 & 0x1F
        body = data[pos + 4:pos + 4 + length * 4]
        pos += 4 + length * 4
        try:
            if pt == RTCP_SR:
                out.append(RtcpSenderReport.parse(body, count))
            elif pt == RTCP_RR:
                out.append(RtcpReceiverReport.parse(body, count))
            elif pt == RTCP_SDES:
                out.append(RtcpSdes.parse(body, count))
            elif pt == RTCP_BYE:
                out.append(RtcpBye.parse(body, count))
            elif pt == RTCP_RTPFB and count == 1:
                out.append(RtcpNack.parse(body))
            elif pt == RTCP_RTPFB and count == 15:
                out.append(RtcpTwcc.parse(body))
            elif pt == RTCP_PSFB and count == 1:
                out.append(RtcpPli(*struct.unpack_from("!II", body)))
            elif pt == RTCP_PSFB and count == 15:
                out.append(RtcpRemb.parse(body))
        except (struct.error, ValueError, IndexError):
            continue
    return out


# ---------------------------------------------------------- ext helpers


def pack_abs_send_time(t_seconds: float) -> bytes:
    """24-bit 6.18 fixed point of the send time (RFC 5285 ext)."""
    v = int(t_seconds * (1 << 18)) & 0xFFFFFF
    return v.to_bytes(3, "big")


def unpack_abs_send_time(data: bytes) -> float:
    return int.from_bytes(data, "big") / (1 << 18)


def pack_twcc_seq(seq: int) -> bytes:
    return struct.pack("!H", seq & 0xFFFF)


def pack_playout_delay(min_ms: int = 0, max_ms: int = 0) -> bytes:
    """12+12-bit playout delay in 10 ms units (reference injects 0/0 to make
    the browser render with minimal delay, gstwebrtc_app.py:1744)."""
    v = ((min_ms // 10) << 12) | (max_ms // 10)
    return v.to_bytes(3, "big")

"""Forward error correction for the video RTP stream: RED + ULP FEC.

RFC 2198 (RED) encapsulation with RFC 5109 (ULP FEC, level 0, 16-bit
mask) recovery packets, the same scheme the reference turns on with its
``ulpfec percentage`` knob on the WebRTC video stream
(reference: src/selkies/legacy/gstwebrtc_app.py:996-1000). NACK/RTX costs
a round trip per loss; FEC recovers single losses inside a protection
group with zero feedback latency — the difference between a blip and a
frozen frame on lossy last-mile paths.

Layout mirrors libwebrtc's use of the RFCs: media packets go on the wire
RED-encapsulated (primary block only), FEC packets ride the same SSRC and
sequence space as RED blocks with the ULPFEC payload type, and the XOR
bit strings are computed over the *de-RED'ed* media packets (original
payload type, everything after the fixed 12-byte header counted as the
protected body).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

RED_PT = 103
ULPFEC_PT = 104


def red_wrap(block_pt: int, payload: bytes) -> bytes:
    """Single-block (primary-only) RED encapsulation: one header octet
    with F=0, then the payload."""
    return bytes([block_pt & 0x7F]) + payload


def red_unwrap(payload: bytes) -> List[Tuple[int, bytes]]:
    """Parse an RFC 2198 RED payload into (block_pt, data) blocks.

    Redundant blocks carry 4-byte headers (F=1 | PT | ts-offset | length);
    the final primary block a 1-byte header. Returns [] on truncation.
    """
    headers: List[Tuple[int, int]] = []      # (pt, length) for redundant
    pos = 0
    primary_pt = None
    while pos < len(payload):
        b0 = payload[pos]
        if not b0 & 0x80:                    # primary block header
            primary_pt = b0 & 0x7F
            pos += 1
            break
        if pos + 4 > len(payload):
            return []
        length = ((payload[pos + 2] & 0x03) << 8) | payload[pos + 3]
        headers.append((b0 & 0x7F, length))
        pos += 4
    if primary_pt is None:
        return []
    out: List[Tuple[int, bytes]] = []
    for pt, length in headers:
        if pos + length > len(payload):
            return []
        out.append((pt, payload[pos:pos + length]))
        pos += length
    out.append((primary_pt, payload[pos:]))
    return out


@dataclass
class FecPacket:
    """Parsed RFC 5109 FEC payload (level 0)."""
    pxcc_rec: int          # P|X|CC recovery (low 6 bits of header byte 0)
    mpt_rec: int           # M|PT recovery
    sn_base: int
    ts_rec: int
    len_rec: int
    prot_len: int
    offsets: Tuple[int, ...]   # protected packets at sn_base + offset
    body: bytes


def _fields(raw: bytes) -> Tuple[int, int, int, int]:
    """(byte0, byte1, timestamp, body_length) of a serialized RTP packet."""
    b0, b1 = raw[0], raw[1]
    ts = struct.unpack_from("!I", raw, 4)[0]
    return b0, b1, ts, len(raw) - 12


def build_fec(packets: List[bytes]) -> bytes:
    """One FEC payload protecting ≤16 serialized media RTP packets with
    consecutive sequence numbers (the first packet's seq is the SN base)."""
    if not 1 <= len(packets) <= 16:
        raise ValueError("ULP FEC (L=0) protects 1..16 packets")
    sn_base = struct.unpack_from("!H", packets[0], 2)[0]
    b0x = b1x = tsx = lenx = 0
    prot_len = 0
    for raw in packets:
        b0, b1, ts, blen = _fields(raw)
        b0x ^= b0
        b1x ^= b1
        tsx ^= ts
        lenx ^= blen
        prot_len = max(prot_len, blen)
    body = bytearray(prot_len)
    for raw in packets:
        pl = raw[12:]
        for i, b in enumerate(pl):
            body[i] ^= b
    mask = 0
    for i in range(len(packets)):
        mask |= 1 << (15 - i)
    hdr = struct.pack(
        "!BBHIH", b0x & 0x3F, b1x, sn_base, tsx & 0xFFFFFFFF, lenx & 0xFFFF)
    level0 = struct.pack("!HH", prot_len, mask)
    return hdr + level0 + bytes(body)


def parse_fec(payload: bytes) -> Optional[FecPacket]:
    if len(payload) < 14:
        return None
    b0, b1, sn_base, tsx, lenx = struct.unpack_from("!BBHIH", payload)
    if b0 & 0x80:
        return None                      # E bit must be 0
    if b0 & 0x40:
        return None                      # L=1 (48-bit mask) unsupported
    prot_len, mask = struct.unpack_from("!HH", payload, 10)
    body = payload[14:]
    if len(body) < prot_len:
        return None
    offsets = tuple(i for i in range(16) if mask & (1 << (15 - i)))
    if not offsets:
        return None
    return FecPacket(pxcc_rec=b0 & 0x3F, mpt_rec=b1, sn_base=sn_base,
                     ts_rec=tsx, len_rec=lenx, prot_len=prot_len,
                     offsets=offsets, body=body[:prot_len])


def recover(fec: FecPacket, have: Dict[int, bytes],
            ssrc: int) -> Optional[Tuple[int, bytes]]:
    """Reconstruct the single missing protected packet, if exactly one is
    missing and every other protected packet is in ``have`` (seq → raw).
    Returns (seq, raw_rtp) or None."""
    protected = [(fec.sn_base + off) & 0xFFFF for off in fec.offsets]
    missing = [s for s in protected if s not in have]
    if len(missing) != 1:
        return None
    b0x, b1x, tsx, lenx = fec.pxcc_rec, fec.mpt_rec, fec.ts_rec, fec.len_rec
    body = bytearray(fec.body)
    for s in protected:
        if s == missing[0]:
            continue
        raw = have[s]
        b0, b1, ts, blen = _fields(raw)
        b0x ^= b0 & 0x3F
        b1x ^= b1
        tsx ^= ts
        lenx ^= blen
        pl = raw[12:]
        for i, b in enumerate(pl[:len(body)]):
            body[i] ^= b
    if lenx > fec.prot_len:
        return None                      # inconsistent FEC — refuse
    hdr = struct.pack("!BBHII", 0x80 | (b0x & 0x3F), b1x,
                      missing[0], tsx & 0xFFFFFFFF, ssrc)
    return missing[0], hdr + bytes(body[:lenx])


class UlpFecEncoder:
    """Groups outgoing media packets and emits one FEC payload per group.

    ``percentage`` follows the reference's knob: FEC overhead as a share
    of media packets (25 → one FEC packet per 4 media packets)."""

    def __init__(self, percentage: int) -> None:
        pct = max(1, min(100, int(percentage)))
        self.group = max(1, min(16, round(100.0 / pct)))
        self._pending: List[bytes] = []

    def push(self, raw_media: bytes) -> Optional[bytes]:
        self._pending.append(raw_media)
        if len(self._pending) < self.group:
            return None
        out = build_fec(self._pending)
        self._pending = []
        return out


class UlpFecDecoder:
    """Receive-side cache + recovery: de-RED'ed media packets in, FEC
    payloads in, recovered raw RTP packets out."""

    MEDIA_CACHE = 512
    FEC_CACHE = 64

    def __init__(self) -> None:
        self._media: Dict[int, bytes] = {}
        self._fecs: List[FecPacket] = []
        self.recovered_count = 0

    def add_media(self, raw: bytes) -> None:
        seq = struct.unpack_from("!H", raw, 2)[0]
        self._media[seq] = raw
        while len(self._media) > self.MEDIA_CACHE:
            del self._media[next(iter(self._media))]

    def add_fec(self, payload: bytes) -> None:
        fec = parse_fec(payload)
        if fec is None:
            return
        self._fecs.append(fec)
        if len(self._fecs) > self.FEC_CACHE:
            del self._fecs[0]

    def try_recover(self, ssrc: int) -> List[bytes]:
        """Attempt recovery with every cached FEC packet; recovered
        packets enter the media cache (they can help later recoveries)."""
        out: List[bytes] = []
        keep: List[FecPacket] = []
        for fec in self._fecs:
            protected = [(fec.sn_base + off) & 0xFFFF for off in fec.offsets]
            missing = [s for s in protected if s not in self._media]
            if not missing:
                continue                 # group complete — FEC spent
            got = recover(fec, self._media, ssrc)
            if got is None:
                keep.append(fec)         # >1 missing: wait for more media
                continue
            seq, raw = got
            self.add_media(raw)
            self.recovered_count += 1
            out.append(raw)
        self._fecs = keep
        return out

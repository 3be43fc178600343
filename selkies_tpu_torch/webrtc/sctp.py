"""SCTP over DTLS + DCEP data channels (RFC 4960 subset, RFC 8831/8832).

Role parity with the vendored ``webrtc/rtcsctptransport.py`` (1,865 LoC,
SURVEY.md §2.4): carries the "input" data channel the reference opens with
ordered + max-retransmits=0 semantics (``legacy/gstwebrtc_app.py:1700``).

Subset implemented (sufficient for browser data channels):
  - INIT/INIT-ACK/COOKIE-ECHO/COOKIE-ACK association setup (DTLS handles
    privacy/auth; the cookie is just opaque state echo)
  - DATA with TSN/SID/SSN/PPID, message fragmentation (B/E bits),
  - SACK with cumulative ack + gap blocks; timer + fast retransmit,
  - HEARTBEAT/HEARTBEAT-ACK, ABORT, SHUTDOWN handling,
  - DCEP DATA_CHANNEL_OPEN / ACK (PPID 50) and string (51) / binary (53)
    payloads; empty-string (56) / empty-binary (57) map to b"".

Congestion control (RFC 4960 §7): a per-association cwnd with slow start
and congestion avoidance gates the DATA send path, so a data channel can
carry bulk payloads (file transfers) without flooding the path; SACK gap
reports drive fast retransmit (ssthresh = cwnd/2), and a T3-RTO collapses
cwnd to one MTU. Sends beyond min(cwnd, peer rwnd) queue in order and
drain on SACK arrival or from ``check_retransmit``.
"""

from __future__ import annotations

import logging
import os
import struct
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

logger = logging.getLogger("selkies_tpu_torch.webrtc.sctp")

# chunk types
CT_DATA = 0
CT_INIT = 1
CT_INIT_ACK = 2
CT_SACK = 3
CT_HEARTBEAT = 4
CT_HEARTBEAT_ACK = 5
CT_ABORT = 6
CT_SHUTDOWN = 7
CT_SHUTDOWN_ACK = 8
CT_ERROR = 9
CT_COOKIE_ECHO = 10
CT_COOKIE_ACK = 11
CT_SHUTDOWN_COMPLETE = 14
CT_FORWARD_TSN = 192

# DCEP (RFC 8832)
PPID_DCEP = 50
PPID_STRING = 51
PPID_BINARY = 53
PPID_STRING_EMPTY = 56
PPID_BINARY_EMPTY = 57

DCEP_OPEN = 0x03
DCEP_ACK = 0x02

CHANNEL_RELIABLE = 0x00
CHANNEL_PARTIAL_RELIABLE_REXMIT = 0x01
CHANNEL_PARTIAL_RELIABLE_TIMED = 0x02
CHANNEL_UNORDERED_FLAG = 0x80

MTU = 1150
RTO = 0.5


def crc32c(data: bytes) -> int:
    """CRC32c (Castagnoli), required by the SCTP common header."""
    crc = 0xFFFFFFFF
    for b in data:
        crc ^= b
        for _ in range(8):
            crc = (crc >> 1) ^ (0x82F63B78 if crc & 1 else 0)
    return crc ^ 0xFFFFFFFF


# table-driven CRC32c for packets of realistic size
_CRC_TABLE = []


def _crc_table():
    global _CRC_TABLE
    if not _CRC_TABLE:
        table = []
        for i in range(256):
            crc = i
            for _ in range(8):
                crc = (crc >> 1) ^ (0x82F63B78 if crc & 1 else 0)
            table.append(crc)
        _CRC_TABLE = table
    return _CRC_TABLE


def crc32c_fast(data: bytes) -> int:
    table = _crc_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = (crc >> 8) ^ table[(crc ^ b) & 0xFF]
    return crc ^ 0xFFFFFFFF


def tsn_gt(a: int, b: int) -> bool:
    return ((a - b) & 0xFFFFFFFF) < 0x80000000 and a != b


def ssn_gt(a: int, b: int) -> bool:
    """16-bit serial comparison for stream sequence numbers."""
    return ((a - b) & 0xFFFF) < 0x8000 and a != b


@dataclass
class DataChannel:
    stream_id: int
    label: str = ""
    protocol: str = ""
    ordered: bool = True
    channel_type: int = CHANNEL_RELIABLE
    reliability: int = 0
    open: bool = False
    on_message: Optional[Callable[[bytes], None]] = None
    on_open: Optional[Callable[[], None]] = None


@dataclass
class _OutChunk:
    tsn: int
    data: bytes                 # full DATA chunk bytes
    sent_at: float
    retransmits: int = 0
    missed: int = 0             # SACK rounds this TSN was reported missing
    fast_rtxed: bool = False


class SctpAssociation:
    """One SCTP association over a DTLS transport (sans-IO)."""

    def __init__(
        self,
        is_client: bool,
        on_send: Callable[[bytes], None],
        port: int = 5000,
    ):
        self.is_client = is_client
        self.on_send = on_send
        self.port = port
        self.state = "closed"       # closed | connecting | established
        self.local_vtag = struct.unpack("!I", os.urandom(4))[0] or 1
        self.remote_vtag = 0
        self.next_tsn = struct.unpack("!I", os.urandom(4))[0]
        self.cum_ack = 0            # last received cumulative TSN
        self._seen_first = False
        self.a_rwnd = 1 << 20
        self.channels: Dict[int, DataChannel] = {}
        self.on_channel: Optional[Callable[[DataChannel], None]] = None

        self._ssn: Dict[int, int] = {}
        self._next_ssn: Dict[int, int] = {}     # sid -> next expected SSN
        self._ordered_hold: Dict[int, Dict[int, Tuple[int, bytes]]] = {}
        self._reasm: Dict[Tuple[int, int], List] = {}
        # unordered fragments reassemble by TSN adjacency, not SSN: senders
        # commonly stamp every unordered message SSN 0, so (sid, ssn) would
        # collide across messages
        self._u_reasm: Dict[int, Dict[int, Tuple[bool, bool, int, bytes]]] = {}
        self._out: Dict[int, _OutChunk] = {}
        self._queue: List[_OutChunk] = []   # cwnd-gated, FIFO by TSN
        # RFC 4960 §7.2.1 initial cwnd; ssthresh starts at the peer's
        # advertised window (updated from every SACK)
        self.cwnd = min(4 * MTU, max(2 * MTU, 4380))
        self.ssthresh = 1 << 20
        # remaining NEW-data allowance: a_rwnd minus outstanding bytes,
        # decremented on each send and recomputed from every SACK
        self.peer_rwnd = 1 << 20
        self.flight = 0                     # DATA chunk bytes outstanding
        self._partial_bytes_acked = 0
        self._last_t3 = 0.0                 # last T3 cwnd-collapse time
        self._recv_tsns: set = set()
        self._next_even_odd = 0 if is_client else 1
        self._setup_chunk: Optional[Tuple[bytes, int]] = None  # (chunk, vtag)
        self._setup_sent_at = 0.0

    # ------------------------------------------------------------ control

    def start(self) -> None:
        # receive() is live as soon as DTLS delivers app data, so on a
        # fast path the peer's INIT/COOKIE exchange can complete before
        # the owning transport gets here — start() must not regress an
        # already-established association back to "connecting"
        if self.state != "closed":
            return
        self.state = "connecting"
        if self.is_client:
            self._send_init()

    def create_channel(self, label: str, protocol: str = "",
                       ordered: bool = True,
                       max_retransmits: Optional[int] = None) -> DataChannel:
        sid = self._next_stream_id()
        ctype = CHANNEL_RELIABLE
        rel = 0
        if max_retransmits is not None:
            ctype = CHANNEL_PARTIAL_RELIABLE_REXMIT
            rel = max_retransmits
        if not ordered:
            ctype |= CHANNEL_UNORDERED_FLAG
        ch = DataChannel(stream_id=sid, label=label, protocol=protocol,
                         ordered=ordered, channel_type=ctype, reliability=rel)
        self.channels[sid] = ch
        if self.state == "established":
            self._send_dcep_open(ch)
        return ch

    def _next_stream_id(self) -> int:
        sid = self._next_even_odd
        while sid in self.channels:
            sid += 2
        self._next_even_odd = sid + 2
        return sid

    def send(self, channel: DataChannel, data, ppid: Optional[int] = None) -> None:
        if isinstance(data, str):
            payload = data.encode()
            ppid = ppid or (PPID_STRING if payload else PPID_STRING_EMPTY)
        else:
            payload = bytes(data)
            ppid = ppid or (PPID_BINARY if payload else PPID_BINARY_EMPTY)
        if not payload:
            payload = b"\x00"  # empty PPIDs carry one padding byte
        self._send_data(channel.stream_id, ppid, payload,
                        unordered=not channel.ordered)

    # ------------------------------------------------------------ timers

    def check_retransmit(self, now: Optional[float] = None) -> None:
        now = time.monotonic() if now is None else now
        if self.state == "connecting" and self._setup_chunk is not None \
                and now - self._setup_sent_at > RTO:
            chunk, vtag = self._setup_chunk
            self._setup_sent_at = now
            self._send_packet([chunk], vtag=vtag)
        # dict preserves insertion order == send order, so this list is
        # already earliest-TSN-first within the association
        expired = [c for c in self._out.values()
                   if now - c.sent_at > RTO * (2 ** min(c.retransmits, 4))]
        if expired:
            # RFC 4960 §7.2.3: collapse cwnd to one MTU FIRST, then
            # retransmit only the earliest chunk(s) that fit that single
            # MTU. The rest stay marked expired; SACK arrivals and later
            # timer fires drive them out, so one timeout cannot re-blast
            # the whole outstanding window into a congested path. The
            # multiplicative decrease applies once per RTO window, not on
            # every 50 ms tick that still sees the draining backlog —
            # otherwise ssthresh gets crushed to its 4-MTU floor and the
            # path-capacity memory it carries is destroyed.
            if now - self._last_t3 >= RTO:
                self._last_t3 = now
                self.ssthresh = max(self.cwnd // 2, 4 * MTU)
                self.cwnd = MTU
                self._partial_bytes_acked = 0
            sent = 0
            for chunk in expired:
                if sent and sent + len(chunk.data) > MTU:
                    break
                chunk.retransmits += 1
                if chunk.retransmits > 8:
                    # RFC 4960 §8.1: endpoint failure — a reliable channel
                    # must not silently turn best-effort
                    logger.error("SCTP peer unreachable after %d "
                                 "retransmits; aborting association",
                                 chunk.retransmits)
                    self.state = "closed"
                    self._out.clear()
                    self._queue.clear()
                    self.flight = 0
                    return
                chunk.sent_at = now
                self._send_packet([chunk.data])
                sent += len(chunk.data)
        self._flush(now)

    # ----------------------------------------------------------- receive

    def receive(self, packet: bytes) -> None:
        if len(packet) < 12:
            return
        src, dst, vtag = struct.unpack_from("!HHI", packet)
        pos = 12
        chunks = []
        while pos + 4 <= len(packet):
            ctype, flags, length = struct.unpack_from("!BBH", packet, pos)
            if length < 4:
                break
            body = packet[pos + 4:pos + length]
            chunks.append((ctype, flags, body))
            pos += length + ((-length) % 4)
        sacked = False
        for ctype, flags, body in chunks:
            if ctype == CT_INIT:
                self._on_init(body)
            elif ctype == CT_INIT_ACK:
                self._on_init_ack(body)
            elif ctype == CT_COOKIE_ECHO:
                self._send_packet([self._chunk(CT_COOKIE_ACK, 0, b"")])
                self._establish()
            elif ctype == CT_COOKIE_ACK:
                self._establish()
            elif ctype == CT_DATA:
                self._on_data(flags, body)
                sacked = True
            elif ctype == CT_SACK:
                self._on_sack(body)
            elif ctype == CT_HEARTBEAT:
                self._send_packet([self._chunk(CT_HEARTBEAT_ACK, 0, body)])
            elif ctype == CT_ABORT:
                self.state = "closed"
            elif ctype == CT_SHUTDOWN:
                self._send_packet([self._chunk(CT_SHUTDOWN_ACK, 0, b"")])
                self.state = "closed"
            elif ctype == CT_SHUTDOWN_ACK:
                self._send_packet([self._chunk(CT_SHUTDOWN_COMPLETE, 0, b"")])
                self.state = "closed"
            elif ctype == CT_FORWARD_TSN:
                self._on_forward_tsn(body)
        if sacked:
            self._send_sack()

    # ------------------------------------------------------ assoc setup

    def _send_init(self) -> None:
        body = struct.pack("!IIHHI", self.local_vtag, self.a_rwnd,
                           1024, 1024, self.next_tsn)
        chunk = self._chunk(CT_INIT, 0, body)
        self._setup_chunk = (chunk, 0)
        self._setup_sent_at = time.monotonic()
        self._send_packet([chunk], vtag=0)

    def _on_init(self, body: bytes) -> None:
        vtag, rwnd, os_, is_, itsn = struct.unpack_from("!IIHHI", body)
        self.remote_vtag = vtag
        self.cum_ack = (itsn - 1) & 0xFFFFFFFF
        self._seen_first = True
        ack = struct.pack("!IIHHI", self.local_vtag, self.a_rwnd,
                          1024, 1024, self.next_tsn)
        cookie = os.urandom(8)
        ack += struct.pack("!HH", 7, 4 + len(cookie)) + cookie  # state cookie
        self._send_packet([self._chunk(CT_INIT_ACK, 0, ack)])

    def _on_init_ack(self, body: bytes) -> None:
        vtag, rwnd, os_, is_, itsn = struct.unpack_from("!IIHHI", body)
        self.remote_vtag = vtag
        self.cum_ack = (itsn - 1) & 0xFFFFFFFF
        self._seen_first = True
        # echo the state cookie parameter
        pos = 16
        cookie = b""
        while pos + 4 <= len(body):
            ptype, plen = struct.unpack_from("!HH", body, pos)
            if ptype == 7:
                cookie = body[pos + 4:pos + plen]
            pos += plen + ((-plen) % 4)
        chunk = self._chunk(CT_COOKIE_ECHO, 0, cookie)
        self._setup_chunk = (chunk, None)
        self._setup_sent_at = time.monotonic()
        self._send_packet([chunk])

    def _establish(self) -> None:
        if self.state == "established":
            return
        self.state = "established"
        self._setup_chunk = None
        for ch in self.channels.values():
            if not ch.open:
                self._send_dcep_open(ch)

    # ------------------------------------------------------------- DATA

    def _send_data(self, sid: int, ppid: int, payload: bytes,
                   unordered: bool = False) -> None:
        ssn = self._ssn.get(sid, 0)
        if not unordered:
            self._ssn[sid] = (ssn + 1) & 0xFFFF
        max_frag = MTU - 16
        pieces = [payload[i:i + max_frag]
                  for i in range(0, len(payload), max_frag)] or [b""]
        for i, piece in enumerate(pieces):
            flags = (0x04 if unordered else 0)
            if i == 0:
                flags |= 0x02                      # B
            if i == len(pieces) - 1:
                flags |= 0x01                      # E
            tsn = self.next_tsn
            self.next_tsn = (self.next_tsn + 1) & 0xFFFFFFFF
            body = struct.pack("!IHHI", tsn, sid, ssn, ppid) + piece
            chunk = self._chunk(CT_DATA, flags, body)
            self._queue.append(_OutChunk(tsn, chunk, 0.0))
        self._flush()

    def _flush(self, now: Optional[float] = None) -> None:
        """Send queued DATA while the flight fits min(cwnd, peer rwnd).

        One chunk is always allowed when nothing is in flight (the
        zero-window probe of RFC 4960 §6.1 A), so the association cannot
        deadlock on a zero advertisement.

        The two windows gate differently: cwnd bounds total outstanding
        bytes (flight + new), while peer_rwnd is already the REMAINING
        new-data allowance (a_rwnd minus outstanding, recomputed on every
        SACK and decremented per send) — comparing flight against it too
        would double-count the in-flight bytes."""
        while self._queue:
            chunk = self._queue[0]
            size = len(chunk.data)
            if self.flight > 0 and (self.flight + size > self.cwnd
                                    or size > self.peer_rwnd):
                return
            self._queue.pop(0)
            chunk.sent_at = time.monotonic() if now is None else now
            self._out[chunk.tsn] = chunk
            self.flight += size
            self.peer_rwnd = max(0, self.peer_rwnd - size)
            self._send_packet([chunk.data])

    def _on_data(self, flags: int, body: bytes) -> None:
        if len(body) < 12:
            return
        tsn, sid, ssn, ppid = struct.unpack_from("!IHHI", body)
        payload = body[12:]
        # at/below the cumulative ack = already delivered (the TSN set is
        # pruned there, so this guard is what stops SACK-loss re-delivery)
        if self._seen_first and not tsn_gt(tsn, self.cum_ack):
            return
        if tsn in self._recv_tsns:
            return
        self._recv_tsns.add(tsn)
        # advance cumulative ack over any contiguous run
        while ((self.cum_ack + 1) & 0xFFFFFFFF) in self._recv_tsns:
            self.cum_ack = (self.cum_ack + 1) & 0xFFFFFFFF
        begin, end = flags & 0x02, flags & 0x01
        unordered = bool(flags & 0x04)
        if begin and end:
            self._deliver_complete(sid, ssn, ppid, payload, unordered)
        elif unordered:
            ufrags = self._u_reasm.setdefault(sid, {})
            ufrags[tsn] = (bool(begin), bool(end), ppid, payload)
            self._try_unordered_reasm(sid, tsn)
        else:
            key = (sid, ssn)
            frags = self._reasm.setdefault(key, [])
            frags.append((tsn, begin, end, payload))
            # serial sort robust to the 32-bit wrap: all fragments of one
            # message lie within a tiny TSN span, so distances measured
            # from (any member - 2^31) are monotone with no discontinuity
            base = (frags[0][0] - 0x80000000) & 0xFFFFFFFF
            frags.sort(key=lambda f: (f[0] - base) & 0xFFFFFFFF)
            if frags[0][1] and frags[-1][2] and \
                    all(((frags[i + 1][0] - frags[i][0]) & 0xFFFFFFFF) == 1
                        for i in range(len(frags) - 1)):
                whole = b"".join(f[3] for f in frags)
                del self._reasm[key]
                self._deliver_complete(sid, ssn, ppid, whole, unordered)

    def _try_unordered_reasm(self, sid: int, tsn: int) -> None:
        """Assemble an unordered message around ``tsn`` by TSN adjacency
        (RFC 4960 §6.6: unordered fragments of one message occupy
        consecutive TSNs from the B fragment to the E fragment)."""
        ufrags = self._u_reasm[sid]
        start = tsn
        while True:
            f = ufrags.get(start)
            if f is None:
                return
            if f[0]:        # B fragment
                break
            start = (start - 1) & 0xFFFFFFFF
        stop = tsn
        while True:
            f = ufrags.get(stop)
            if f is None:
                return
            if f[1]:        # E fragment
                break
            stop = (stop + 1) & 0xFFFFFFFF
        run = []
        t = start
        while True:
            run.append(t)
            if t == stop:
                break
            t = (t + 1) & 0xFFFFFFFF
        ppid = ufrags[start][2]
        whole = b"".join(ufrags[t][3] for t in run)
        for t in run:
            del ufrags[t]
        self._deliver(sid, ppid, whole)

    def _on_forward_tsn(self, body: bytes) -> None:
        """RFC 3758: the peer abandoned chunks up to a new cumulative TSN.

        Advance the receive state so ordered streams do not hold back
        forever behind an abandoned SSN."""
        if len(body) < 4:
            return
        new_cum = struct.unpack_from("!I", body)[0]
        if not tsn_gt(new_cum, self.cum_ack):
            return
        self.cum_ack = new_cum
        self._seen_first = True
        # continue over anything contiguous we already hold
        while ((self.cum_ack + 1) & 0xFFFFFFFF) in self._recv_tsns:
            self.cum_ack = (self.cum_ack + 1) & 0xFFFFFFFF
        pos = 4
        while pos + 4 <= len(body):
            sid, ssn = struct.unpack_from("!HH", body, pos)
            pos += 4
            old = self._next_ssn.setdefault(sid, 0)
            new_next = (ssn + 1) & 0xFFFF
            hold = self._ordered_hold.get(sid, {})
            if ssn_gt(new_next, old):
                # the skip unblocks fully received messages queued at or
                # below the abandoned SSN — deliver them, don't drop them
                for s in sorted(hold, key=lambda s: (s - old) & 0xFFFF):
                    if ssn_gt(s, ssn):
                        continue
                    item = hold.pop(s)
                    self._deliver(sid, item[0], item[1])
                self._next_ssn[sid] = new_next
            # drop reassembly state for abandoned messages on this stream
            for key in [k for k in self._reasm
                        if k[0] == sid and not ssn_gt(k[1], ssn)]:
                del self._reasm[key]
            # release anything now contiguous past the skip
            while True:
                nxt = self._next_ssn[sid]
                item = hold.pop(nxt, None)
                if item is None:
                    break
                self._next_ssn[sid] = (nxt + 1) & 0xFFFF
                self._deliver(sid, item[0], item[1])
        self._prune_unordered_reasm(new_cum)
        self._send_sack()

    def _prune_unordered_reasm(self, cum: int) -> None:
        """Unordered fragments of messages abandoned by a FORWARD TSN can
        never complete (TSNs at/below cum are dropped on arrival) — free
        them instead of leaking per-connection memory."""
        for ufrags in self._u_reasm.values():
            for t in [t for t in ufrags if not tsn_gt(t, cum)]:
                del ufrags[t]
            # cascade upward: a non-B fragment at boundary+1 whose
            # predecessor was abandoned can never reach its B fragment
            boundary = cum
            for t in sorted(ufrags, key=lambda x: (x - cum) & 0xFFFFFFFF):
                prev = (t - 1) & 0xFFFFFFFF
                if not ufrags[t][0] and prev not in ufrags \
                        and not tsn_gt(prev, boundary):
                    del ufrags[t]
                    boundary = t

    def _deliver_complete(self, sid: int, ssn: int, ppid: int,
                          payload: bytes, unordered: bool) -> None:
        """Deliver a fully reassembled message, honoring stream ordering.

        Ordered streams (the "input" data channel is opened ordered) must
        not surface messages in TSN-completion order under UDP reordering —
        e.g. keyup before keydown. Hold out-of-order messages per stream
        and release them in SSN sequence.
        """
        if unordered:
            self._deliver(sid, ppid, payload)
            return
        nxt = self._next_ssn.setdefault(sid, 0)
        if ssn != nxt and not ssn_gt(ssn, nxt):
            return  # stale duplicate of an already-delivered SSN
        hold = self._ordered_hold.setdefault(sid, {})
        hold[ssn] = (ppid, payload)
        while True:
            nxt = self._next_ssn[sid]
            item = hold.pop(nxt, None)
            if item is None:
                return
            self._next_ssn[sid] = (nxt + 1) & 0xFFFF
            self._deliver(sid, item[0], item[1])

    def _send_sack(self) -> None:
        gaps = b""
        n_gaps = 0
        # gap ack blocks relative to cum_ack
        pending = sorted(t for t in self._recv_tsns if tsn_gt(t, self.cum_ack))
        start = end = None
        blocks = []
        for t in pending:
            off = (t - self.cum_ack) & 0xFFFFFFFF
            if start is None:
                start = end = off
            elif off == end + 1:
                end = off
            else:
                blocks.append((start, end))
                start = end = off
        if start is not None:
            blocks.append((start, end))
        for s, e in blocks[:20]:
            if e > 0xFFFF:
                # gap-block offsets are 16-bit; anything further ahead is
                # left for the peer's RTX timer rather than raising
                # struct.error out of the receive path
                continue
            gaps += struct.pack("!HH", s, e)
            n_gaps += 1
        body = struct.pack("!IIHH", self.cum_ack, self.a_rwnd, n_gaps, 0) + gaps
        self._send_packet([self._chunk(CT_SACK, 0, body)])
        # TSNs at or below the cumulative ack can never be needed again
        self._recv_tsns = {t for t in self._recv_tsns
                           if tsn_gt(t, self.cum_ack)}

    def _on_sack(self, body: bytes) -> None:
        if len(body) < 12:
            return
        cum, rwnd, n_gaps, n_dups = struct.unpack_from("!IIHH", body)
        acked_bytes = 0

        def _ack(tsn: int) -> None:
            nonlocal acked_bytes
            chunk = self._out.pop(tsn, None)
            if chunk is not None:
                acked_bytes += len(chunk.data)
                self.flight = max(0, self.flight - len(chunk.data))

        for tsn in list(self._out):
            if not tsn_gt(tsn, cum):
                _ack(tsn)
        pos = 12
        gap_acked: set = set()
        highest = cum
        for _ in range(n_gaps):
            if pos + 4 > len(body):
                break
            s, e = struct.unpack_from("!HH", body, pos)
            pos += 4
            for off in range(s, e + 1):
                t = (cum + off) & 0xFFFFFFFF
                gap_acked.add(t)
                if tsn_gt(t, highest):
                    highest = t
                _ack(t)
        if acked_bytes:
            if self.cwnd <= self.ssthresh:
                # slow start: at most one MTU per SACK that acks new data
                self.cwnd += min(acked_bytes, MTU)
            else:
                # congestion avoidance: one MTU per cwnd of acked bytes
                self._partial_bytes_acked += acked_bytes
                if self._partial_bytes_acked >= self.cwnd:
                    self._partial_bytes_acked -= self.cwnd
                    self.cwnd += MTU
        # fast retransmit (RFC 4960 §7.2.4): a TSN below the highest
        # gap-acked TSN reported missing by 3 SACKs goes out immediately,
        # once, with multiplicative decrease
        fast_rtx = False
        if gap_acked:
            for tsn, chunk in self._out.items():
                if tsn_gt(highest, tsn) and tsn not in gap_acked:
                    chunk.missed += 1
                    if chunk.missed >= 3 and not chunk.fast_rtxed:
                        chunk.fast_rtxed = True
                        chunk.sent_at = time.monotonic()
                        self._send_packet([chunk.data])
                        fast_rtx = True
        if fast_rtx:
            self.ssthresh = max(self.cwnd // 2, 4 * MTU)
            self.cwnd = self.ssthresh
            self._partial_bytes_acked = 0
        # RFC 4960 §6.2.1: the usable window is the advertised a_rwnd less
        # bytes still in flight that this SACK did not cover, so _flush
        # cannot overrun the receiver's buffer by a full flight
        self.peer_rwnd = max(0, rwnd - self.flight)
        self._flush()

    # ------------------------------------------------------------- DCEP

    def _send_dcep_open(self, ch: DataChannel) -> None:
        label = ch.label.encode()
        proto = ch.protocol.encode()
        msg = struct.pack("!BBHIHH", DCEP_OPEN, ch.channel_type, 0,
                          ch.reliability, len(label), len(proto))
        msg += label + proto
        self._send_data(ch.stream_id, PPID_DCEP, msg)

    def _deliver(self, sid: int, ppid: int, payload: bytes) -> None:
        if ppid == PPID_DCEP:
            self._on_dcep(sid, payload)
            return
        ch = self.channels.get(sid)
        if ch is None:
            return
        if ppid in (PPID_STRING_EMPTY, PPID_BINARY_EMPTY):
            payload = b""
        if ch.on_message is not None:
            ch.on_message(payload)

    def _on_dcep(self, sid: int, payload: bytes) -> None:
        if not payload:
            return
        if payload[0] == DCEP_OPEN:
            (_, ctype, prio, rel, llen, plen) = struct.unpack_from(
                "!BBHIHH", payload)
            label = payload[12:12 + llen].decode(errors="replace")
            proto = payload[12 + llen:12 + llen + plen].decode(errors="replace")
            ch = self.channels.get(sid)
            if ch is None:
                ch = DataChannel(stream_id=sid, label=label, protocol=proto,
                                 ordered=not (ctype & CHANNEL_UNORDERED_FLAG),
                                 channel_type=ctype, reliability=rel)
                self.channels[sid] = ch
            ch.open = True
            self._send_data(sid, PPID_DCEP, bytes([DCEP_ACK]))
            if self.on_channel is not None:
                self.on_channel(ch)
            if ch.on_open is not None:
                ch.on_open()
        elif payload[0] == DCEP_ACK:
            ch = self.channels.get(sid)
            if ch is not None and not ch.open:
                ch.open = True
                if ch.on_open is not None:
                    ch.on_open()

    # ------------------------------------------------------------- wire

    def _chunk(self, ctype: int, flags: int, body: bytes) -> bytes:
        chunk = struct.pack("!BBH", ctype, flags, 4 + len(body)) + body
        return chunk + b"\x00" * ((-len(chunk)) % 4)

    def _send_packet(self, chunks: List[bytes], vtag: Optional[int] = None) -> None:
        vtag = self.remote_vtag if vtag is None else vtag
        hdr = struct.pack("!HHI", self.port, self.port, vtag)
        packet = hdr + struct.pack("!I", 0) + b"".join(chunks)
        crc = crc32c_fast(packet)
        packet = hdr + struct.pack("<I", crc) + b"".join(chunks)
        self.on_send(packet)

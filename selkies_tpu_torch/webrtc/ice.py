"""ICE agent (RFC 8445 subset): host + server-reflexive candidates, full
connectivity checks with aggressive nomination, peer-reflexive learning.

Replaces aioice (used by the reference's vendored stack at
``webrtc/rtcicetransport.py``, SURVEY.md §2.4) — not available here, so
implemented directly on asyncio datagram transports + :mod:`.stun`.

Non-STUN traffic received on the selected pair (DTLS, RTP — RFC 7983
demux) is handed to ``on_data``; ``send()`` ships application bytes on the
nominated pair. TURN relaying is delegated to the deployment's coturn
(server side is on a public address in the reference architecture); a TURN
client allocation is future work and flagged in SURVEY §7.
"""

from __future__ import annotations

import asyncio
import hashlib
import logging
import os
import secrets
import socket
import string
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from . import stun

logger = logging.getLogger("selkies_tpu_torch.webrtc.ice")

RTO = 0.5
MAX_RETRIES = 5


def random_string(n: int, alphabet: str = string.ascii_letters + string.digits) -> str:
    return "".join(secrets.choice(alphabet) for _ in range(n))


def candidate_priority(type_pref: int, local_pref: int = 65535,
                       component: int = 1) -> int:
    return (type_pref << 24) | (local_pref << 8) | (256 - component)


TYPE_PREFS = {"host": 126, "prflx": 110, "srflx": 100, "relay": 0}


@dataclass(frozen=True)
class Candidate:
    foundation: str
    component: int
    transport: str
    priority: int
    host: str
    port: int
    type: str

    def to_sdp(self) -> str:
        return (f"candidate:{self.foundation} {self.component} "
                f"{self.transport} {self.priority} {self.host} {self.port} "
                f"typ {self.type}")

    @classmethod
    def from_sdp(cls, line: str) -> "Candidate":
        if line.startswith("a="):
            line = line[2:]
        if line.startswith("candidate:"):
            line = line[len("candidate:"):]
        parts = line.split()
        typ = "host"
        if "typ" in parts:
            typ = parts[parts.index("typ") + 1]
        return cls(parts[0], int(parts[1]), parts[2].lower(), int(parts[3]),
                   parts[4], int(parts[5]), typ)


def local_addresses() -> List[str]:
    """Best-effort list of local unicast IPv4 addresses."""
    addrs = []
    try:
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            s.connect(("8.8.8.8", 80))  # no packets sent for UDP connect
            addrs.append(s.getsockname()[0])
        finally:
            s.close()
    except OSError:
        pass
    try:
        for info in socket.getaddrinfo(socket.gethostname(), None,
                                       socket.AF_INET):
            addrs.append(info[4][0])
    except OSError:
        pass
    addrs.append("127.0.0.1")
    seen, out = set(), []
    for a in addrs:
        if a not in seen:
            seen.add(a)
            out.append(a)
    return out


@dataclass
class _Pair:
    local: Candidate
    remote: Candidate
    state: str = "waiting"     # waiting | inprogress | succeeded | failed
    nominated: bool = False

    @property
    def addr(self) -> Tuple[str, int]:
        return (self.remote.host, self.remote.port)


class _Protocol(asyncio.DatagramProtocol):
    def __init__(self, agent: "IceAgent", local_cand: Candidate):
        self.agent = agent
        self.local_cand = local_cand
        self.transport: Optional[asyncio.DatagramTransport] = None

    def connection_made(self, transport):
        self.transport = transport

    def datagram_received(self, data, addr):
        self.agent._datagram(self, data, addr)


class IceAgent:
    def __init__(
        self,
        controlling: bool,
        stun_server: Optional[Tuple[str, int]] = None,
        components: int = 1,
        interfaces: Optional[List[str]] = None,
    ):
        self.controlling = controlling
        self.stun_server = stun_server
        self.local_ufrag = random_string(4)
        self.local_pwd = random_string(22)
        self.remote_ufrag: Optional[str] = None
        self.remote_pwd: Optional[str] = None
        self.local_candidates: List[Candidate] = []
        self.remote_candidates: List[Candidate] = []
        self.on_data: Optional[Callable[[bytes], None]] = None
        self.tie_breaker = int.from_bytes(os.urandom(8), "big")
        self._interfaces = interfaces
        self._protocols: Dict[Tuple[str, int], _Protocol] = {}  # local addr
        self._pairs: List[_Pair] = []
        self._selected: Optional[_Pair] = None
        self._selected_protocol: Optional[_Protocol] = None
        self._connected_evt = asyncio.Event()
        self._pending: Dict[bytes, asyncio.Future] = {}
        self._closed = False

    # ------------------------------------------------------------ gather

    async def gather(self) -> List[Candidate]:
        loop = asyncio.get_running_loop()
        for ip in (self._interfaces or local_addresses()):
            try:
                cand = Candidate(
                    foundation=hashlib.md5(ip.encode()).hexdigest()[:8],
                    component=1, transport="udp",
                    priority=candidate_priority(TYPE_PREFS["host"]),
                    host=ip, port=0, type="host")
                proto = _Protocol(self, cand)
                transport, _ = await loop.create_datagram_endpoint(
                    lambda p=proto: p, local_addr=(ip, 0))
                port = transport.get_extra_info("sockname")[1]
                cand = Candidate(cand.foundation, 1, "udp", cand.priority,
                                 ip, port, "host")
                proto.local_cand = cand
                self._protocols[(ip, port)] = proto
                self.local_candidates.append(cand)
            except OSError:
                continue
        if self.stun_server:
            await self._gather_srflx()
        return self.local_candidates

    async def _gather_srflx(self) -> None:
        for proto in list(self._protocols.values()):
            req = stun.StunMessage(method=stun.BINDING,
                                   msg_class=stun.CLASS_REQUEST)
            try:
                resp = await self._request(proto, req, self.stun_server,
                                           integrity_key=None)
            except (asyncio.TimeoutError, OSError):
                continue
            mapped = resp.xor_mapped_address()
            if mapped and mapped[0] != proto.local_cand.host:
                cand = Candidate(
                    foundation=hashlib.md5(
                        f"srflx{mapped}".encode()).hexdigest()[:8],
                    component=1, transport="udp",
                    priority=candidate_priority(TYPE_PREFS["srflx"]),
                    host=mapped[0], port=mapped[1], type="srflx")
                self.local_candidates.append(cand)

    # ------------------------------------------------------------ control

    def set_remote_credentials(self, ufrag: str, pwd: str) -> None:
        self.remote_ufrag = ufrag
        self.remote_pwd = pwd

    def add_remote_candidate(self, cand: Optional[Candidate]) -> None:
        if cand is None or cand.transport != "udp":
            return
        self.remote_candidates.append(cand)
        for proto in self._protocols.values():
            self._pairs.append(_Pair(proto.local_cand, cand))
        self._sort_pairs()

    def _sort_pairs(self) -> None:
        def prio(p: _Pair) -> int:
            g = p.local.priority if self.controlling else p.remote.priority
            d = p.remote.priority if self.controlling else p.local.priority
            return (min(g, d) << 32) + 2 * max(g, d) + (1 if g > d else 0)
        self._pairs.sort(key=prio, reverse=True)

    async def connect(self, timeout: float = 10.0) -> None:
        """Run connectivity checks until one pair is nominated."""
        if not self._pairs:
            raise ConnectionError("no candidate pairs")
        checker = asyncio.create_task(self._check_loop())
        try:
            await asyncio.wait_for(self._connected_evt.wait(), timeout)
        finally:
            checker.cancel()

    async def _check_loop(self) -> None:
        while not self._connected_evt.is_set() and not self._closed:
            for pair in list(self._pairs):
                if pair.state in ("succeeded", "failed", "inprogress"):
                    continue
                pair.state = "inprogress"
                asyncio.ensure_future(self._check_pair(pair))
            await asyncio.sleep(0.05)

    async def _check_pair(self, pair: _Pair) -> None:
        proto = self._protocols.get((pair.local.host, pair.local.port))
        if proto is None or self.remote_pwd is None:
            pair.state = "failed"
            return
        req = stun.StunMessage(method=stun.BINDING,
                               msg_class=stun.CLASS_REQUEST)
        req.set_username(f"{self.remote_ufrag}:{self.local_ufrag}")
        req.attributes[stun.ATTR_PRIORITY] = candidate_priority(
            TYPE_PREFS["prflx"]).to_bytes(4, "big")
        if self.controlling:
            req.attributes[stun.ATTR_ICE_CONTROLLING] = \
                self.tie_breaker.to_bytes(8, "big")
            req.attributes[stun.ATTR_USE_CANDIDATE] = b""  # aggressive
        else:
            req.attributes[stun.ATTR_ICE_CONTROLLED] = \
                self.tie_breaker.to_bytes(8, "big")
        try:
            await self._request(proto, req, pair.addr,
                                integrity_key=self.remote_pwd.encode())
        except (asyncio.TimeoutError, OSError):
            pair.state = "failed"
            return
        pair.state = "succeeded"
        if self.controlling:
            self._nominate(pair, proto)

    def _nominate(self, pair: _Pair, proto: _Protocol) -> None:
        if self._selected is None:
            pair.nominated = True
            self._selected = pair
            self._selected_protocol = proto
            self._connected_evt.set()
            logger.info("ICE nominated %s:%d -> %s:%d",
                        pair.local.host, pair.local.port,
                        pair.remote.host, pair.remote.port)

    # ------------------------------------------------------------ wire

    async def _request(self, proto: _Protocol, msg: stun.StunMessage,
                       addr: Tuple[str, int],
                       integrity_key: Optional[bytes]) -> stun.StunMessage:
        fut = asyncio.get_running_loop().create_future()
        self._pending[msg.transaction_id] = fut
        payload = msg.serialize(integrity_key=integrity_key)
        try:
            for i in range(MAX_RETRIES):
                proto.transport.sendto(payload, addr)
                try:
                    return await asyncio.wait_for(
                        asyncio.shield(fut), RTO * (2 ** i))
                except asyncio.TimeoutError:
                    continue
            raise asyncio.TimeoutError("STUN request timed out")
        finally:
            self._pending.pop(msg.transaction_id, None)

    def _datagram(self, proto: _Protocol, data: bytes,
                  addr: Tuple[str, int]) -> None:
        if stun.is_stun(data):
            try:
                msg = stun.StunMessage.parse(data)
            except ValueError:
                return
            self._handle_stun(proto, msg, addr)
            return
        if self.on_data is not None:
            self.on_data(data)

    def _handle_stun(self, proto: _Protocol, msg: stun.StunMessage,
                     addr: Tuple[str, int]) -> None:
        if msg.msg_class in (stun.CLASS_SUCCESS, stun.CLASS_ERROR):
            fut = self._pending.get(msg.transaction_id)
            if fut is not None and not fut.done():
                if msg.msg_class == stun.CLASS_ERROR:
                    fut.set_exception(OSError(f"STUN error {msg.error()}"))
                else:
                    fut.set_result(msg)
            return
        if msg.msg_class != stun.CLASS_REQUEST:
            return
        # inbound connectivity check
        if self.local_pwd and not msg.verify_integrity(self.local_pwd.encode()):
            resp = stun.StunMessage(stun.BINDING, stun.CLASS_ERROR,
                                    msg.transaction_id)
            resp.set_error(401, "Unauthorized")
            proto.transport.sendto(resp.serialize(), addr)
            return
        resp = stun.StunMessage(stun.BINDING, stun.CLASS_SUCCESS,
                                msg.transaction_id)
        resp.set_xor_mapped_address(addr)
        proto.transport.sendto(
            resp.serialize(integrity_key=self.local_pwd.encode()), addr)
        # learn peer-reflexive candidates / accept nomination
        known = any(c.host == addr[0] and c.port == addr[1]
                    for c in self.remote_candidates)
        if not known:
            prio = int.from_bytes(
                msg.attributes.get(stun.ATTR_PRIORITY, b"\x00" * 4), "big")
            self.add_remote_candidate(Candidate(
                foundation="prflx", component=1, transport="udp",
                priority=prio or candidate_priority(TYPE_PREFS["prflx"]),
                host=addr[0], port=addr[1], type="prflx"))
        if not self.controlling \
                and stun.ATTR_USE_CANDIDATE in msg.attributes:
            for pair in self._pairs:
                if pair.addr == addr and \
                        (pair.local.host, pair.local.port) == (
                            proto.local_cand.host, proto.local_cand.port):
                    pair.nominated = True
                    self._selected = pair
                    self._selected_protocol = proto
                    self._connected_evt.set()
                    break

    # ------------------------------------------------------------ app data

    def send(self, data: bytes) -> None:
        if self._selected is None or self._selected_protocol is None:
            raise ConnectionError("ICE not connected")
        self._selected_protocol.transport.sendto(data, self._selected.addr)

    @property
    def selected_pair(self) -> Optional[Tuple[Candidate, Candidate]]:
        if self._selected is None:
            return None
        return (self._selected.local, self._selected.remote)

    async def close(self) -> None:
        self._closed = True
        for proto in self._protocols.values():
            if proto.transport is not None:
                proto.transport.close()
        self._protocols.clear()

"""STUN message codec (RFC 5389) with the ICE attributes of RFC 8445.

Foundation for :mod:`.ice` connectivity checks and server-reflexive
candidate discovery against the coturn/STUN infrastructure the reference
deploys (``addons/coturn/``, SURVEY.md §2.6). aioice is not available in
this environment; this is a from-scratch codec.
"""

from __future__ import annotations

import hashlib
import hmac
import os
import struct
import zlib
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

MAGIC_COOKIE = 0x2112A442
HEADER_LEN = 20
FINGERPRINT_XOR = 0x5354554E

# methods / classes
BINDING = 0x001
CLASS_REQUEST = 0x00
CLASS_INDICATION = 0x01
CLASS_SUCCESS = 0x02
CLASS_ERROR = 0x03

# attributes
ATTR_MAPPED_ADDRESS = 0x0001
ATTR_USERNAME = 0x0006
ATTR_MESSAGE_INTEGRITY = 0x0008
ATTR_ERROR_CODE = 0x0009
ATTR_XOR_MAPPED_ADDRESS = 0x0020
ATTR_PRIORITY = 0x0024
ATTR_USE_CANDIDATE = 0x0025
ATTR_SOFTWARE = 0x8022
ATTR_FINGERPRINT = 0x8028
ATTR_ICE_CONTROLLED = 0x8029
ATTR_ICE_CONTROLLING = 0x802A


def message_type(method: int, msg_class: int) -> int:
    """Interleave method and class bits per RFC 5389 §6."""
    m = method
    return ((m & 0x0F80) << 2) | ((m & 0x0070) << 1) | (m & 0x000F) \
        | ((msg_class & 2) << 7) | ((msg_class & 1) << 4)


def split_type(mtype: int) -> Tuple[int, int]:
    method = ((mtype >> 2) & 0x0F80) | ((mtype >> 1) & 0x0070) | (mtype & 0x000F)
    msg_class = ((mtype >> 7) & 2) | ((mtype >> 4) & 1)
    return method, msg_class


def xor_address(addr: Tuple[str, int], transaction_id: bytes) -> bytes:
    import ipaddress

    ip = ipaddress.ip_address(addr[0])
    port = addr[1] ^ (MAGIC_COOKIE >> 16)
    if ip.version == 4:
        xip = int(ip) ^ MAGIC_COOKIE
        return struct.pack("!BBH", 0, 0x01, port) + xip.to_bytes(4, "big")
    xor_key = MAGIC_COOKIE.to_bytes(4, "big") + transaction_id
    raw = bytes(a ^ b for a, b in zip(ip.packed, xor_key))
    return struct.pack("!BBH", 0, 0x02, port) + raw


def unxor_address(data: bytes, transaction_id: bytes) -> Tuple[str, int]:
    import ipaddress

    family = data[1]
    port = struct.unpack_from("!H", data, 2)[0] ^ (MAGIC_COOKIE >> 16)
    if family == 0x01:
        ip = int.from_bytes(data[4:8], "big") ^ MAGIC_COOKIE
        return str(ipaddress.IPv4Address(ip)), port
    xor_key = MAGIC_COOKIE.to_bytes(4, "big") + transaction_id
    raw = bytes(a ^ b for a, b in zip(data[4:20], xor_key))
    return str(ipaddress.IPv6Address(raw)), port


@dataclass
class StunMessage:
    method: int = BINDING
    msg_class: int = CLASS_REQUEST
    transaction_id: bytes = field(default_factory=lambda: os.urandom(12))
    attributes: Dict[int, bytes] = field(default_factory=dict)

    # -- attribute sugar ---------------------------------------------------

    def set_xor_mapped_address(self, addr: Tuple[str, int]) -> None:
        self.attributes[ATTR_XOR_MAPPED_ADDRESS] = xor_address(
            addr, self.transaction_id)

    def xor_mapped_address(self) -> Optional[Tuple[str, int]]:
        raw = self.attributes.get(ATTR_XOR_MAPPED_ADDRESS)
        return unxor_address(raw, self.transaction_id) if raw else None

    def set_username(self, username: str) -> None:
        self.attributes[ATTR_USERNAME] = username.encode()

    def username(self) -> Optional[str]:
        raw = self.attributes.get(ATTR_USERNAME)
        return raw.decode() if raw is not None else None

    def set_error(self, code: int, reason: str = "") -> None:
        self.attributes[ATTR_ERROR_CODE] = struct.pack(
            "!HBB", 0, code // 100, code % 100) + reason.encode()

    def error(self) -> Optional[Tuple[int, str]]:
        raw = self.attributes.get(ATTR_ERROR_CODE)
        if raw is None:
            return None
        return raw[2] * 100 + raw[3], raw[4:].decode(errors="replace")

    # -- serialize / parse -------------------------------------------------

    def serialize(self, integrity_key: Optional[bytes] = None,
                  add_fingerprint: bool = True) -> bytes:
        body = b""
        for attr, value in self.attributes.items():
            body += struct.pack("!HH", attr, len(value)) + value
            body += b"\x00" * ((-len(value)) % 4)

        def header(extra_len: int) -> bytes:
            return struct.pack(
                "!HHI", message_type(self.method, self.msg_class),
                len(body) + extra_len, MAGIC_COOKIE) + self.transaction_id

        if integrity_key is not None:
            mac = hmac.new(integrity_key, header(24) + body, hashlib.sha1).digest()
            body += struct.pack("!HH", ATTR_MESSAGE_INTEGRITY, 20) + mac
        if add_fingerprint:
            crc = (zlib.crc32(header(8) + body) & 0xFFFFFFFF) ^ FINGERPRINT_XOR
            body += struct.pack("!HHI", ATTR_FINGERPRINT, 4, crc)
        return header(0) + body

    @classmethod
    def parse(cls, data: bytes) -> "StunMessage":
        if len(data) < HEADER_LEN:
            raise ValueError("STUN message too short")
        mtype, length, cookie = struct.unpack_from("!HHI", data)
        if cookie != MAGIC_COOKIE:
            raise ValueError("bad magic cookie")
        if mtype & 0xC000:
            raise ValueError("not a STUN message")
        if len(data) < HEADER_LEN + length:
            raise ValueError("truncated STUN message")
        method, msg_class = split_type(mtype)
        msg = cls(method=method, msg_class=msg_class,
                  transaction_id=data[8:20], attributes={})
        pos = HEADER_LEN
        end = HEADER_LEN + length
        while pos + 4 <= end:
            attr, alen = struct.unpack_from("!HH", data, pos)
            pos += 4
            msg.attributes[attr] = data[pos:pos + alen]
            pos += alen + ((-alen) % 4)
        return msg

    def verify_integrity(self, key: bytes) -> bool:
        mac = self.attributes.get(ATTR_MESSAGE_INTEGRITY)
        if mac is None:
            return False
        clone = StunMessage(self.method, self.msg_class, self.transaction_id,
                            {})
        for attr, value in self.attributes.items():
            if attr in (ATTR_MESSAGE_INTEGRITY, ATTR_FINGERPRINT):
                continue
            clone.attributes[attr] = value
        expect = StunMessage.parse(
            clone.serialize(integrity_key=key, add_fingerprint=False)
        ).attributes[ATTR_MESSAGE_INTEGRITY]
        return hmac.compare_digest(mac, expect)


def is_stun(data: bytes) -> bool:
    """First-octet demux per RFC 7983: 0-3 = STUN."""
    return len(data) >= HEADER_LEN and data[0] < 4 \
        and struct.unpack_from("!I", data, 4)[0] == MAGIC_COOKIE

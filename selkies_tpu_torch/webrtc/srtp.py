"""SRTP/SRTCP protection (RFC 3711) for the DTLS-SRTP profile
SRTP_AES128_CM_HMAC_SHA1_80 (RFC 5764 §4.1.2).

Replaces pylibsrtp (used by the reference's vendored stack at
``webrtc/rtcdtlstransport.py:44-51``, not available here) with a pure
Python implementation on ``cryptography``'s AES-CTR + HMAC-SHA1: session
key derivation (§4.3 AES-CM KDF), RTP/RTCP encrypt + 80-bit auth tags,
ROC/sequence tracking with the §3.3.1 index estimate, and a 64-entry
replay window.

Throughput note: media encryption happens per packet on the host CPU;
~1200-byte packets at 60 fps × a few packets/frame is well within
hashlib/AES-NI performance. (The heavy lifting — media encode — is on
the card; SRTP is framing.)
"""

from __future__ import annotations

import hmac as hmac_mod
import struct
from hashlib import sha1
from typing import Optional, Tuple

from cryptography.hazmat.primitives.ciphers import Cipher, algorithms, modes

SRTP_AES128_CM_HMAC_SHA1_80 = 0x0001
PROFILE_NAMES = {SRTP_AES128_CM_HMAC_SHA1_80: "SRTP_AES128_CM_HMAC_SHA1_80"}

KEY_LEN = 16
SALT_LEN = 14
AUTH_KEY_LEN = 20
AUTH_TAG_LEN = 10      # 80 bits
REPLAY_WINDOW = 64

# KDF labels (RFC 3711 §4.3.2)
LABEL_RTP_ENCRYPTION = 0x00
LABEL_RTP_AUTH = 0x01
LABEL_RTP_SALT = 0x02
LABEL_RTCP_ENCRYPTION = 0x03
LABEL_RTCP_AUTH = 0x04
LABEL_RTCP_SALT = 0x05


def _aes_cm_keystream(key: bytes, iv16: bytes, length: int) -> bytes:
    cipher = Cipher(algorithms.AES(key), modes.CTR(iv16))
    enc = cipher.encryptor()
    return enc.update(b"\x00" * length) + enc.finalize()


def kdf(master_key: bytes, master_salt: bytes, label: int,
        length: int, index: int = 0, kdr: int = 0) -> bytes:
    """AES-CM key derivation (RFC 3711 §4.3.1/§4.3.3)."""
    div = (index // kdr) if kdr else 0
    key_id = (label << 48) | div
    x = int.from_bytes(master_salt, "big") ^ key_id
    iv = (x << 16).to_bytes(16, "big")
    return _aes_cm_keystream(master_key, iv, length)


class _ReplayWindow:
    def __init__(self):
        self.highest: Optional[int] = None
        self.mask = 0

    def check_and_update(self, index: int) -> bool:
        if self.highest is None:
            self.highest = index
            self.mask = 1
            return True
        if index > self.highest:
            shift = index - self.highest
            self.mask = ((self.mask << shift) | 1) & ((1 << REPLAY_WINDOW) - 1)
            self.highest = index
            return True
        delta = self.highest - index
        if delta >= REPLAY_WINDOW or (self.mask >> delta) & 1:
            return False
        self.mask |= 1 << delta
        return True


class SrtpContext:
    """One direction of an SRTP session (one master key/salt)."""

    def __init__(self, master_key: bytes, master_salt: bytes):
        if len(master_key) != KEY_LEN or len(master_salt) != SALT_LEN:
            raise ValueError("bad master key/salt length")
        self.rtp_key = kdf(master_key, master_salt, LABEL_RTP_ENCRYPTION, KEY_LEN)
        self.rtp_auth = kdf(master_key, master_salt, LABEL_RTP_AUTH, AUTH_KEY_LEN)
        self.rtp_salt = kdf(master_key, master_salt, LABEL_RTP_SALT, SALT_LEN)
        self.rtcp_key = kdf(master_key, master_salt, LABEL_RTCP_ENCRYPTION, KEY_LEN)
        self.rtcp_auth = kdf(master_key, master_salt, LABEL_RTCP_AUTH, AUTH_KEY_LEN)
        self.rtcp_salt = kdf(master_key, master_salt, LABEL_RTCP_SALT, SALT_LEN)
        # per-SSRC state
        self._roc: dict = {}         # ssrc -> rollover counter
        self._s_l: dict = {}         # ssrc -> highest seq seen
        self._replay: dict = {}      # ssrc -> _ReplayWindow
        self._rtcp_index = 0
        self._rtcp_replay: dict = {}

    # ---------------------------------------------------------------- RTP

    def _rtp_index(self, ssrc: int, seq: int) -> int:
        """§3.3.1 packet index estimate from ROC and highest seq."""
        roc = self._roc.get(ssrc, 0)
        s_l = self._s_l.get(ssrc)
        if s_l is None:
            return (roc << 16) | seq
        if s_l < 32768:
            v = roc - 1 if seq - s_l > 32768 else roc
        else:
            v = roc + 1 if s_l - seq > 32768 else roc
        return (max(v, 0) << 16) | seq

    def _advance(self, ssrc: int, seq: int, index: int) -> None:
        roc = index >> 16
        s_l = self._s_l.get(ssrc)
        if s_l is None or index > ((self._roc.get(ssrc, 0) << 16) | s_l):
            self._roc[ssrc] = roc
            self._s_l[ssrc] = seq

    def _rtp_iv(self, ssrc: int, index: int) -> bytes:
        x = (int.from_bytes(self.rtp_salt, "big") << 16) \
            ^ (ssrc << 64) ^ (index << 16)
        return (x & ((1 << 128) - 1)).to_bytes(16, "big")

    @staticmethod
    def _header_len(packet: bytes) -> int:
        cc = packet[0] & 0x0F
        pos = 12 + 4 * cc
        if packet[0] & 0x10:  # extension
            if len(packet) < pos + 4:
                raise ValueError("truncated RTP header")
            (_, words) = struct.unpack_from("!HH", packet, pos)
            pos += 4 + words * 4
        return pos

    def protect_rtp(self, packet: bytes) -> bytes:
        ssrc = struct.unpack_from("!I", packet, 8)[0]
        seq = struct.unpack_from("!H", packet, 2)[0]
        index = self._rtp_index(ssrc, seq)
        self._advance(ssrc, seq, index)
        hdr_len = self._header_len(packet)
        keystream = _aes_cm_keystream(
            self.rtp_key, self._rtp_iv(ssrc, index), len(packet) - hdr_len)
        enc = bytes(a ^ b for a, b in zip(packet[hdr_len:], keystream))
        auth_in = packet[:hdr_len] + enc + (index >> 16).to_bytes(4, "big")
        tag = hmac_mod.new(self.rtp_auth, auth_in, sha1).digest()[:AUTH_TAG_LEN]
        return packet[:hdr_len] + enc + tag

    def unprotect_rtp(self, data: bytes) -> bytes:
        if len(data) < 12 + AUTH_TAG_LEN:
            raise ValueError("SRTP packet too short")
        packet, tag = data[:-AUTH_TAG_LEN], data[-AUTH_TAG_LEN:]
        ssrc = struct.unpack_from("!I", packet, 8)[0]
        seq = struct.unpack_from("!H", packet, 2)[0]
        index = self._rtp_index(ssrc, seq)
        auth_in = packet + (index >> 16).to_bytes(4, "big")
        expect = hmac_mod.new(self.rtp_auth, auth_in, sha1).digest()[:AUTH_TAG_LEN]
        if not hmac_mod.compare_digest(tag, expect):
            raise ValueError("SRTP auth failure")
        replay = self._replay.setdefault(ssrc, _ReplayWindow())
        if not replay.check_and_update(index):
            raise ValueError("SRTP replay")
        self._advance(ssrc, seq, index)
        hdr_len = self._header_len(packet)
        keystream = _aes_cm_keystream(
            self.rtp_key, self._rtp_iv(ssrc, index), len(packet) - hdr_len)
        return packet[:hdr_len] + bytes(
            a ^ b for a, b in zip(packet[hdr_len:], keystream))

    # --------------------------------------------------------------- RTCP

    def _rtcp_iv(self, ssrc: int, index: int) -> bytes:
        x = (int.from_bytes(self.rtcp_salt, "big") << 16) \
            ^ (ssrc << 64) ^ (index << 16)
        return (x & ((1 << 128) - 1)).to_bytes(16, "big")

    def protect_rtcp(self, packet: bytes) -> bytes:
        ssrc = struct.unpack_from("!I", packet, 4)[0]
        self._rtcp_index = (self._rtcp_index + 1) & 0x7FFFFFFF
        index = self._rtcp_index
        keystream = _aes_cm_keystream(
            self.rtcp_key, self._rtcp_iv(ssrc, index), len(packet) - 8)
        enc = packet[:8] + bytes(
            a ^ b for a, b in zip(packet[8:], keystream))
        e_index = struct.pack("!I", 0x80000000 | index)  # E-bit set
        auth_in = enc + e_index
        tag = hmac_mod.new(self.rtcp_auth, auth_in, sha1).digest()[:AUTH_TAG_LEN]
        return enc + e_index + tag

    def unprotect_rtcp(self, data: bytes) -> bytes:
        if len(data) < 8 + 4 + AUTH_TAG_LEN:
            raise ValueError("SRTCP packet too short")
        tag = data[-AUTH_TAG_LEN:]
        e_index_raw = data[-AUTH_TAG_LEN - 4:-AUTH_TAG_LEN]
        enc = data[:-AUTH_TAG_LEN - 4]
        expect = hmac_mod.new(
            self.rtcp_auth, enc + e_index_raw, sha1).digest()[:AUTH_TAG_LEN]
        if not hmac_mod.compare_digest(tag, expect):
            raise ValueError("SRTCP auth failure")
        (e_index,) = struct.unpack("!I", e_index_raw)
        index = e_index & 0x7FFFFFFF
        ssrc = struct.unpack_from("!I", enc, 4)[0]
        replay = self._rtcp_replay.setdefault(ssrc, _ReplayWindow())
        if not replay.check_and_update(index):
            raise ValueError("SRTCP replay")
        if not e_index & 0x80000000:
            return enc  # unencrypted SRTCP
        keystream = _aes_cm_keystream(
            self.rtcp_key, self._rtcp_iv(ssrc, index), len(enc) - 8)
        return enc[:8] + bytes(a ^ b for a, b in zip(enc[8:], keystream))


def srtp_pair_from_dtls(
    keying_material: bytes, is_client: bool,
) -> Tuple[SrtpContext, SrtpContext]:
    """Split RFC 5764 §4.2 exporter output into (tx, rx) contexts.

    Layout: client_key | server_key | client_salt | server_salt.
    """
    ck = keying_material[0:16]
    sk = keying_material[16:32]
    cs = keying_material[32:46]
    ss = keying_material[46:60]
    client_ctx = SrtpContext(ck, cs)
    server_ctx = SrtpContext(sk, ss)
    return (client_ctx, server_ctx) if is_client else (server_ctx, client_ctx)

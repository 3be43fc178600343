"""DTLS 1.2 endpoint (RFC 6347) with DTLS-SRTP keying (RFC 5764).

Role parity with the reference's vendored ``webrtc/rtcdtlstransport.py``
(OpenSSL + pyOpenSSL + pylibsrtp, SURVEY.md §2.4) — none of those bindings
exist in this environment, so the handshake is implemented directly on
``cryptography`` hazmat primitives:

  cipher suite   TLS_ECDHE_ECDSA_WITH_AES_128_GCM_SHA256 (0xC02B)
  curve          secp256r1, signature ecdsa_secp256r1_sha256 (0x0403)
  certificates   self-signed ECDSA P-256, mutual (WebRTC style), verified
                 by SHA-256 fingerprint against the peer's SDP a=fingerprint
  key export     RFC 5705 exporter "EXTRACTOR-dtls_srtp" → SRTP master keys
  app data       AES-128-GCM records (carries SCTP for data channels)

Flights retransmit whole on a doubling timer (RFC 6347 §4.2.4). Handshake
fragmentation is reassembled on receive; sends fit one record (P-256 certs
are ~600 B). HelloVerifyRequest is omitted (permitted by RFC 6347 §4.2.1).
"""

from __future__ import annotations

import hashlib
import hmac as hmac_mod
import logging
import os
import struct
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from cryptography import x509
from cryptography.hazmat.primitives import hashes, serialization
from cryptography.hazmat.primitives.asymmetric import ec
from cryptography.hazmat.primitives.ciphers.aead import AESGCM
from cryptography.x509.oid import NameOID

logger = logging.getLogger("selkies_tpu_torch.webrtc.dtls")

DTLS_1_0 = 0xFEFF
DTLS_1_2 = 0xFEFD

CT_CCS = 20
CT_ALERT = 21
CT_HANDSHAKE = 22
CT_APPDATA = 23

HT_CLIENT_HELLO = 1
HT_SERVER_HELLO = 2
HT_HELLO_VERIFY = 3
HT_CERTIFICATE = 11
HT_SERVER_KEY_EXCHANGE = 12
HT_CERTIFICATE_REQUEST = 13
HT_SERVER_HELLO_DONE = 14
HT_CERTIFICATE_VERIFY = 15
HT_CLIENT_KEY_EXCHANGE = 16
HT_FINISHED = 20

CIPHER_ECDHE_ECDSA_AES128_GCM_SHA256 = 0xC02B
CURVE_SECP256R1 = 23
SIGALG_ECDSA_SHA256 = 0x0403

EXT_SUPPORTED_GROUPS = 10
EXT_EC_POINT_FORMATS = 11
EXT_SIGNATURE_ALGS = 13
EXT_USE_SRTP = 14
EXT_RENEGOTIATION_INFO = 0xFF01

SRTP_AES128_CM_HMAC_SHA1_80 = 0x0001
SRTP_KEYING_MATERIAL_LEN = 60   # 2*16 key + 2*14 salt

MASTER_SECRET_LEN = 48
VERIFY_DATA_LEN = 12
GCM_TAG_LEN = 16
RETRANSMIT_BASE = 1.0
MAX_FLIGHT_SENDS = 6


# ------------------------------------------------------------------ PRF


def _p_hash(secret: bytes, seed: bytes, length: int) -> bytes:
    out = b""
    a = seed
    while len(out) < length:
        a = hmac_mod.new(secret, a, hashlib.sha256).digest()
        out += hmac_mod.new(secret, a + seed, hashlib.sha256).digest()
    return out[:length]


def prf(secret: bytes, label: bytes, seed: bytes, length: int) -> bytes:
    return _p_hash(secret, label + seed, length)


# ---------------------------------------------------------- certificates


@dataclass
class DtlsCertificate:
    private_key: ec.EllipticCurvePrivateKey
    certificate: x509.Certificate

    @classmethod
    def generate(cls, common_name: str = "selkies-tpu") -> "DtlsCertificate":
        import datetime

        key = ec.generate_private_key(ec.SECP256R1())
        name = x509.Name(
            [x509.NameAttribute(NameOID.COMMON_NAME, common_name)])
        now = datetime.datetime(2024, 1, 1)
        cert = (
            x509.CertificateBuilder()
            .subject_name(name).issuer_name(name)
            .public_key(key.public_key())
            .serial_number(x509.random_serial_number())
            .not_valid_before(now)
            .not_valid_after(now + datetime.timedelta(days=3650))
            .sign(key, hashes.SHA256())
        )
        return cls(key, cert)

    @property
    def der(self) -> bytes:
        return self.certificate.public_bytes(serialization.Encoding.DER)

    def fingerprint(self) -> str:
        digest = hashlib.sha256(self.der).hexdigest().upper()
        return "sha-256 " + ":".join(
            digest[i:i + 2] for i in range(0, len(digest), 2))


def fingerprint_of_der(der: bytes) -> str:
    digest = hashlib.sha256(der).hexdigest().upper()
    return "sha-256 " + ":".join(
        digest[i:i + 2] for i in range(0, len(digest), 2))


# ------------------------------------------------------------ wire utils


def _hs_header(msg_type: int, length: int, msg_seq: int) -> bytes:
    return struct.pack("!B", msg_type) + length.to_bytes(3, "big") \
        + struct.pack("!H", msg_seq) + (0).to_bytes(3, "big") \
        + length.to_bytes(3, "big")


def _merge_range(ranges: list, start: int, end: int) -> None:
    """Insert [start, end) into a sorted list of disjoint ranges, merging."""
    if end <= start:
        return
    out = []
    for s, e in ranges:
        if e < start or s > end:
            out.append((s, e))
        else:
            start = min(start, s)
            end = max(end, e)
    out.append((start, end))
    out.sort()
    ranges[:] = out


class _Buffer:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def read(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("short read")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def u8(self) -> int:
        return self.read(1)[0]

    def u16(self) -> int:
        return struct.unpack("!H", self.read(2))[0]

    def u24(self) -> int:
        return int.from_bytes(self.read(3), "big")

    def vec8(self) -> bytes:
        return self.read(self.u8())

    def vec16(self) -> bytes:
        return self.read(self.u16())

    @property
    def remaining(self) -> int:
        return len(self.data) - self.pos


# ------------------------------------------------------------- endpoint


@dataclass
class _PendingFlight:
    records: List[Tuple[int, bytes, int]] = field(default_factory=list)
    # (content_type, payload, epoch) — re-encrypted per retransmit
    sends: int = 0
    next_at: float = 0.0


class DtlsEndpoint:
    """Sans-IO DTLS endpoint: feed datagrams in, datagrams come out via
    ``on_send``; app data out via ``on_data``; completion via
    ``handshake_complete``/``export_srtp``."""

    def __init__(
        self,
        is_client: bool,
        certificate: Optional[DtlsCertificate] = None,
        on_send: Optional[Callable[[bytes], None]] = None,
        remote_fingerprint: Optional[str] = None,
        mtu: int = 1200,
    ):
        self.is_client = is_client
        self.cert = certificate or DtlsCertificate.generate()
        self.on_send = on_send or (lambda d: None)
        self.on_data: Optional[Callable[[bytes], None]] = None
        self.remote_fingerprint = remote_fingerprint
        self.mtu = mtu

        self.handshake_complete = False
        self.handshake_failed: Optional[str] = None

        self._epoch_out = 0
        self._epoch_in = 0
        self._seq_out: Dict[int, int] = {0: 0, 1: 0}
        self._msg_seq_out = 0
        self._next_recv_msg_seq = 0
        self._transcript = b""
        self._frag_buf: Dict[int, Dict] = {}

        self._client_random = os.urandom(32)
        self._server_random = os.urandom(32)
        self._ecdh_priv = ec.generate_private_key(ec.SECP256R1())
        self._peer_pub: Optional[ec.EllipticCurvePublicKey] = None
        self._peer_cert_der: Optional[bytes] = None
        self._peer_cert_verified = False
        self._replay_highest: Dict[int, int] = {}   # epoch -> highest seq
        self._replay_mask: Dict[int, int] = {}      # epoch -> 64-bit window
        self._master_secret: Optional[bytes] = None
        self._client_write_key = b""
        self._server_write_key = b""
        self._client_iv = b""
        self._server_iv = b""
        self._flight = _PendingFlight()
        self._started = False

    # ------------------------------------------------------------ public

    def start(self) -> None:
        """Client: send flight 1. Server: wait for ClientHello."""
        self._started = True
        if self.is_client:
            self._send_client_hello()

    def export_srtp(self) -> bytes:
        """RFC 5705 exporter for the dtls_srtp label (no context)."""
        if not self.handshake_complete or self._master_secret is None:
            raise RuntimeError("handshake not complete")
        return prf(self._master_secret, b"EXTRACTOR-dtls_srtp",
                   self._client_random + self._server_random,
                   SRTP_KEYING_MATERIAL_LEN)

    def local_fingerprint(self) -> str:
        return self.cert.fingerprint()

    def peer_fingerprint(self) -> Optional[str]:
        if self._peer_cert_der is None:
            return None
        return fingerprint_of_der(self._peer_cert_der)

    def send_app_data(self, data: bytes) -> None:
        if not self.handshake_complete:
            raise RuntimeError("handshake not complete")
        self._emit_record(CT_APPDATA, data)

    def check_retransmit(self, now: Optional[float] = None) -> None:
        """Call periodically; retransmits the last flight if unanswered."""
        if self.handshake_complete or not self._flight.records:
            return
        now = time.monotonic() if now is None else now
        if now < self._flight.next_at:
            return
        if self._flight.sends >= MAX_FLIGHT_SENDS:
            self.handshake_failed = "timeout"
            return
        self._retransmit()

    # --------------------------------------------------------- record IO

    def receive(self, datagram: bytes) -> None:
        pos = 0
        while pos + 13 <= len(datagram):
            ctype, ver, epoch = struct.unpack_from("!BHH", datagram, pos)
            seq = int.from_bytes(datagram[pos + 5:pos + 11], "big")
            (length,) = struct.unpack_from("!H", datagram, pos + 11)
            payload = datagram[pos + 13:pos + 13 + length]
            pos += 13 + length
            if epoch > 0:
                if not self._replay_check(epoch, seq):
                    continue
                try:
                    payload = self._decrypt(ctype, epoch, seq, payload)
                except Exception:
                    continue  # bogus record
                self._replay_update(epoch, seq)
            self._handle_record(ctype, payload)

    def _replay_check(self, epoch: int, seq: int) -> bool:
        """Sliding 64-entry anti-replay window (RFC 6347 §4.1.2.6)."""
        highest = self._replay_highest.get(epoch)
        if highest is None or seq > highest:
            return True
        delta = highest - seq
        return delta < 64 and not (self._replay_mask.get(epoch, 0) >> delta) & 1

    def _replay_update(self, epoch: int, seq: int) -> None:
        highest = self._replay_highest.get(epoch)
        mask = self._replay_mask.get(epoch, 0)
        if highest is None or seq > highest:
            shift = seq - highest if highest is not None else 1
            mask = ((mask << shift) | 1) & ((1 << 64) - 1)
            self._replay_highest[epoch] = seq
        else:
            mask |= 1 << (highest - seq)
        self._replay_mask[epoch] = mask

    def _decrypt(self, ctype: int, epoch: int, seq: int, payload: bytes) -> bytes:
        key = self._client_write_key if not self.is_client else self._server_write_key
        iv = self._client_iv if not self.is_client else self._server_iv
        explicit = payload[:8]
        nonce = iv + explicit
        cipher = AESGCM(key)
        seq_bytes = struct.pack("!H", epoch) + seq.to_bytes(6, "big")
        plain_len = len(payload) - 8 - GCM_TAG_LEN
        aad = seq_bytes + struct.pack("!BHH", ctype, DTLS_1_2, plain_len)
        return cipher.decrypt(nonce, payload[8:], aad)

    def _encrypt(self, ctype: int, payload: bytes) -> bytes:
        key = self._client_write_key if self.is_client else self._server_write_key
        iv = self._client_iv if self.is_client else self._server_iv
        epoch = self._epoch_out
        seq = self._seq_out[epoch]
        seq_bytes = struct.pack("!H", epoch) + seq.to_bytes(6, "big")
        nonce = iv + seq_bytes
        aad = seq_bytes + struct.pack("!BHH", ctype, DTLS_1_2, len(payload))
        return seq_bytes + AESGCM(key).encrypt(nonce, payload, aad)

    def _emit_record(self, ctype: int, payload: bytes,
                     epoch: Optional[int] = None, track: bool = False) -> None:
        epoch = self._epoch_out if epoch is None else epoch
        body = payload
        if epoch > 0:
            body = self._encrypt(ctype, payload)
        seq = self._seq_out[epoch]
        self._seq_out[epoch] = seq + 1
        hdr = struct.pack("!BHH", ctype, DTLS_1_2, epoch) \
            + seq.to_bytes(6, "big") + struct.pack("!H", len(body))
        self.on_send(hdr + body)
        if track:
            self._flight.records.append((ctype, payload, epoch))

    def _retransmit(self) -> None:
        records = self._flight.records
        self._flight.records = []
        for ctype, payload, epoch in records:
            self._emit_record(ctype, payload, epoch=epoch, track=True)
        self._flight.sends += 1
        self._flight.next_at = time.monotonic() + RETRANSMIT_BASE \
            * (2 ** self._flight.sends)

    def _new_flight(self) -> None:
        self._flight = _PendingFlight()
        self._flight.sends = 1
        self._flight.next_at = time.monotonic() + RETRANSMIT_BASE

    # ----------------------------------------------------- handshake I/O

    def _send_handshake(self, msg_type: int, body: bytes,
                        track: bool = True) -> None:
        hdr = _hs_header(msg_type, len(body), self._msg_seq_out)
        self._msg_seq_out += 1
        msg = hdr + body
        if msg_type != HT_HELLO_VERIFY:
            self._transcript += msg
        self._emit_record(CT_HANDSHAKE, msg, track=track)

    def _handle_record(self, ctype: int, payload: bytes) -> None:
        if ctype == CT_CCS:
            self._epoch_in = 1
            return
        if ctype == CT_ALERT:
            if len(payload) >= 2 and payload[0] == 2:
                self.handshake_failed = f"fatal alert {payload[1]}"
            return
        if ctype == CT_APPDATA:
            if self.on_data is not None:
                self.on_data(payload)
            return
        if ctype != CT_HANDSHAKE:
            return
        buf = _Buffer(payload)
        while buf.remaining >= 12:
            msg_type = buf.u8()
            length = buf.u24()
            msg_seq = struct.unpack("!H", buf.read(2))[0]
            frag_off = buf.u24()
            frag_len = buf.u24()
            frag = buf.read(frag_len)
            self._feed_fragment(msg_type, length, msg_seq, frag_off, frag)

    def _feed_fragment(self, msg_type: int, length: int, msg_seq: int,
                       frag_off: int, frag: bytes) -> None:
        if msg_seq < self._next_recv_msg_seq:
            # Peer retransmitted a message we've already processed — our
            # responding flight must have been lost (RFC 6347 §4.2.4);
            # re-send it even if our handshake is locally complete.
            if self._flight.records:
                self._retransmit()
            return
        slot = self._frag_buf.setdefault(
            msg_seq, {"type": msg_type, "len": length,
                      "data": bytearray(length), "ranges": []})
        if frag_off + len(frag) > slot["len"]:
            return  # fragment exceeds the declared message length
        data = slot["data"]
        data[frag_off:frag_off + len(frag)] = frag
        # Track received byte *ranges*, not a running count: retransmitted
        # or overlapping fragments must not double-count and declare the
        # message complete while holes remain zero-filled.
        _merge_range(slot["ranges"], frag_off, frag_off + len(frag))
        # numbering-convention tolerance: RFC 6347 has each side start its
        # message_seq at 0, but some stacks continue a single handshake-wide
        # sequence. Adopt the peer's numbering ONLY off its flight-opening
        # ServerHello (a lost seq-0 message must not shift us: anything
        # other than a flight opener arriving first just waits for the
        # retransmission). Transcript hashing is unaffected — both sides
        # hash the wire bytes as sent.
        if self.is_client and self._next_recv_msg_seq == 0 \
                and 0 not in self._frag_buf:
            lowest = min(self._frag_buf)
            if self._frag_buf[lowest]["type"] == HT_SERVER_HELLO:
                self._next_recv_msg_seq = lowest
        # process in order
        while True:
            slot = self._frag_buf.get(self._next_recv_msg_seq)
            if slot is None or \
                    sum(e - s for s, e in slot["ranges"]) < slot["len"]:
                return
            del self._frag_buf[self._next_recv_msg_seq]
            self._next_recv_msg_seq += 1
            body = bytes(slot["data"])
            full = _hs_header(slot["type"], slot["len"],
                              self._next_recv_msg_seq - 1) + body
            try:
                self._handle_handshake(slot["type"], body, full)
            except Exception as exc:  # protocol violation
                logger.exception("DTLS handshake error")
                self.handshake_failed = str(exc)
                return

    # --------------------------------------------------- message builders

    def _hello_extensions(self) -> bytes:
        exts = b""
        exts += struct.pack("!HHH", EXT_SUPPORTED_GROUPS, 4, 2) \
            + struct.pack("!H", CURVE_SECP256R1)
        exts += struct.pack("!HHB", EXT_EC_POINT_FORMATS, 2, 1) + b"\x00"
        exts += struct.pack("!HHH", EXT_SIGNATURE_ALGS, 4, 2) \
            + struct.pack("!H", SIGALG_ECDSA_SHA256)
        exts += struct.pack("!HHH", EXT_USE_SRTP, 5, 2) \
            + struct.pack("!H", SRTP_AES128_CM_HMAC_SHA1_80) + b"\x00"
        exts += struct.pack("!HHB", EXT_RENEGOTIATION_INFO, 1, 0)
        return exts

    def _send_client_hello(self) -> None:
        self._new_flight()
        exts = self._hello_extensions()
        body = struct.pack("!H", DTLS_1_2) + self._client_random \
            + b"\x00" + b"\x00" \
            + struct.pack("!H", 2) \
            + struct.pack("!H", CIPHER_ECDHE_ECDSA_AES128_GCM_SHA256) \
            + b"\x01\x00" \
            + struct.pack("!H", len(exts)) + exts
        self._send_handshake(HT_CLIENT_HELLO, body)

    def _ecdh_public_bytes(self) -> bytes:
        return self._ecdh_priv.public_key().public_bytes(
            serialization.Encoding.X962,
            serialization.PublicFormat.UncompressedPoint)

    def _server_flight(self) -> None:
        self._new_flight()
        # ServerHello
        exts = b""
        exts += struct.pack("!HHB", EXT_EC_POINT_FORMATS, 2, 1) + b"\x00"
        exts += struct.pack("!HHH", EXT_USE_SRTP, 5, 2) \
            + struct.pack("!H", SRTP_AES128_CM_HMAC_SHA1_80) + b"\x00"
        exts += struct.pack("!HHB", EXT_RENEGOTIATION_INFO, 1, 0)
        body = struct.pack("!H", DTLS_1_2) + self._server_random + b"\x00" \
            + struct.pack("!H", CIPHER_ECDHE_ECDSA_AES128_GCM_SHA256) \
            + b"\x00" + struct.pack("!H", len(exts)) + exts
        self._send_handshake(HT_SERVER_HELLO, body)
        # Certificate
        der = self.cert.der
        certs = len(der).to_bytes(3, "big") + der
        self._send_handshake(
            HT_CERTIFICATE, len(certs).to_bytes(3, "big") + certs)
        # ServerKeyExchange
        pub = self._ecdh_public_bytes()
        params = b"\x03" + struct.pack("!H", CURVE_SECP256R1) \
            + bytes([len(pub)]) + pub
        signed = self._client_random + self._server_random + params
        sig = self.cert.private_key.sign(signed, ec.ECDSA(hashes.SHA256()))
        ske = params + struct.pack("!H", SIGALG_ECDSA_SHA256) \
            + struct.pack("!H", len(sig)) + sig
        self._send_handshake(HT_SERVER_KEY_EXCHANGE, ske)
        # CertificateRequest (mutual auth, WebRTC style)
        creq = b"\x01\x40" + struct.pack("!HH", 2, SIGALG_ECDSA_SHA256) \
            + struct.pack("!H", 0)
        self._send_handshake(HT_CERTIFICATE_REQUEST, creq)
        # ServerHelloDone
        self._send_handshake(HT_SERVER_HELLO_DONE, b"")

    def _client_flight2(self) -> None:
        self._new_flight()
        # Certificate
        der = self.cert.der
        certs = len(der).to_bytes(3, "big") + der
        self._send_handshake(
            HT_CERTIFICATE, len(certs).to_bytes(3, "big") + certs)
        # ClientKeyExchange
        pub = self._ecdh_public_bytes()
        self._send_handshake(HT_CLIENT_KEY_EXCHANGE, bytes([len(pub)]) + pub)
        # CertificateVerify over the transcript so far
        sig = self.cert.private_key.sign(
            self._transcript, ec.ECDSA(hashes.SHA256()))
        cv = struct.pack("!H", SIGALG_ECDSA_SHA256) \
            + struct.pack("!H", len(sig)) + sig
        self._send_handshake(HT_CERTIFICATE_VERIFY, cv)
        # keys, CCS, Finished
        self._compute_keys()
        self._emit_record(CT_CCS, b"\x01", track=True)
        self._epoch_out = 1
        verify = prf(self._master_secret, b"client finished",
                     hashlib.sha256(self._transcript).digest(),
                     VERIFY_DATA_LEN)
        self._send_handshake(HT_FINISHED, verify)

    def _server_flight2(self) -> None:
        self._new_flight()
        self._emit_record(CT_CCS, b"\x01", track=True)
        self._epoch_out = 1
        verify = prf(self._master_secret, b"server finished",
                     hashlib.sha256(self._transcript).digest(),
                     VERIFY_DATA_LEN)
        self._send_handshake(HT_FINISHED, verify)

    # ----------------------------------------------------- state machine

    def _handle_handshake(self, msg_type: int, body: bytes,
                          full_msg: bytes) -> None:
        if msg_type == HT_CLIENT_HELLO and not self.is_client:
            self._transcript = full_msg
            buf = _Buffer(body)
            buf.u16()                       # client_version
            self._client_random = buf.read(32)
            buf.vec8()                      # session id
            buf.vec8()                      # cookie
            suites = buf.vec16()
            if struct.pack("!H", CIPHER_ECDHE_ECDSA_AES128_GCM_SHA256) \
                    not in [suites[i:i + 2] for i in range(0, len(suites), 2)]:
                raise ValueError("no common cipher suite")
            self._server_flight()
            return

        if msg_type == HT_SERVER_HELLO and self.is_client:
            self._transcript += full_msg
            buf = _Buffer(body)
            buf.u16()
            self._server_random = buf.read(32)
            buf.vec8()
            suite = buf.u16()
            if suite != CIPHER_ECDHE_ECDSA_AES128_GCM_SHA256:
                raise ValueError("unexpected cipher suite")
        elif msg_type == HT_CERTIFICATE:
            self._transcript += full_msg
            buf = _Buffer(body)
            total = buf.u24()
            if total:
                self._peer_cert_der = buf.read(buf.u24())
                self._verify_peer_fingerprint()
                self._peer_cert_verified = True
        elif msg_type == HT_SERVER_KEY_EXCHANGE and self.is_client:
            self._transcript += full_msg
            buf = _Buffer(body)
            curve_type = buf.u8()
            curve = buf.u16()
            if curve_type != 3 or curve != CURVE_SECP256R1:
                raise ValueError("unsupported ECDHE params")
            point = buf.vec8()
            sigalg = buf.u16()
            sig = buf.vec16()
            peer_cert = x509.load_der_x509_certificate(self._peer_cert_der)
            params = b"\x03" + struct.pack("!H", CURVE_SECP256R1) \
                + bytes([len(point)]) + point
            peer_cert.public_key().verify(
                sig, self._client_random + self._server_random + params,
                ec.ECDSA(hashes.SHA256()))
            self._peer_pub = ec.EllipticCurvePublicKey.from_encoded_point(
                ec.SECP256R1(), point)
        elif msg_type == HT_CERTIFICATE_REQUEST and self.is_client:
            self._transcript += full_msg
        elif msg_type == HT_SERVER_HELLO_DONE and self.is_client:
            self._transcript += full_msg
            self._client_flight2()
        elif msg_type == HT_CLIENT_KEY_EXCHANGE and not self.is_client:
            self._transcript += full_msg
            buf = _Buffer(body)
            point = buf.vec8()
            self._peer_pub = ec.EllipticCurvePublicKey.from_encoded_point(
                ec.SECP256R1(), point)
            self._compute_keys()
        elif msg_type == HT_CERTIFICATE_VERIFY and not self.is_client:
            buf = _Buffer(body)
            buf.u16()
            sig = buf.vec16()
            transcript_before = self._transcript
            peer_cert = x509.load_der_x509_certificate(self._peer_cert_der)
            peer_cert.public_key().verify(
                sig, transcript_before, ec.ECDSA(hashes.SHA256()))
            self._peer_key_proven = True
            self._transcript += full_msg
        elif msg_type == HT_FINISHED:
            # mutual auth is mandatory when an SDP fingerprint was pinned:
            # a peer that skipped Certificate/CertificateVerify must not
            # complete the handshake (WebRTC requires client certs).
            if self.remote_fingerprint is not None and \
                    not self._peer_cert_verified:
                raise ValueError("peer sent no certificate")
            if not self.is_client and self.remote_fingerprint is not None \
                    and not getattr(self, "_peer_key_proven", False):
                raise ValueError("client sent no CertificateVerify")
            label = b"client finished" if not self.is_client \
                else b"server finished"
            expect = prf(self._master_secret, label,
                         hashlib.sha256(self._transcript).digest(),
                         VERIFY_DATA_LEN)
            if not hmac_mod.compare_digest(expect, body):
                raise ValueError("Finished verify_data mismatch")
            self._transcript += full_msg
            if self.is_client:
                self.handshake_complete = True
                self._flight = _PendingFlight()
            else:
                self._server_flight2()
                self.handshake_complete = True
        else:
            self._transcript += full_msg

    def _verify_peer_fingerprint(self) -> None:
        if self.remote_fingerprint is None:
            return
        got = fingerprint_of_der(self._peer_cert_der).lower().replace(
            "sha-256 ", "")
        want = self.remote_fingerprint.lower().replace("sha-256", "").strip()
        if got != want:
            raise ValueError("certificate fingerprint mismatch")

    def _compute_keys(self) -> None:
        shared = self._ecdh_priv.exchange(ec.ECDH(), self._peer_pub)
        self._master_secret = prf(
            shared, b"master secret",
            self._client_random + self._server_random, MASTER_SECRET_LEN)
        key_block = prf(
            self._master_secret, b"key expansion",
            self._server_random + self._client_random, 2 * 16 + 2 * 4)
        self._client_write_key = key_block[0:16]
        self._server_write_key = key_block[16:32]
        self._client_iv = key_block[32:36]
        self._server_iv = key_block[36:40]

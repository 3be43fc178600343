"""PeerConnection: JSEP orchestration of ICE + DTLS-SRTP + RTP + SCTP.

Role parity with the vendored ``webrtc/rtcpeerconnection.py`` (SURVEY.md
§2.4), scoped to what the streaming platform needs: a sendrecv video
track carrying externally-encoded H.264 (the encoder's bitstream — never
re-encoded), an Opus audio track, and DCEP data channels for the input
plane. Bundle-only (one transport for everything), rtcp-mux, DTLS role
from SDP ``a=setup``, ICE role from offerer-ship.

Demux on the single socket follows RFC 7983: STUN is consumed inside the
IceAgent; first byte 20-63 → DTLS records (handshake + SCTP app data);
128-191 → SRTP/SRTCP (split by RTCP packet-type range).
"""

from __future__ import annotations

import asyncio
import logging
import os
import struct
import time
from typing import Callable, Dict, List, Optional, Tuple

from .dtls import DtlsCertificate, DtlsEndpoint
from .fec import (ULPFEC_PT, UlpFecDecoder, UlpFecEncoder,
                  red_unwrap, red_wrap)
from .h264 import H264Depayloader, H264Payloader
from .ice import Candidate, IceAgent
from .jitterbuffer import JitterBuffer
from .opus import OpusDepayloader, OpusPayloader
from .rate import GccEstimator
from .rtp import (RtcpNack, RtcpPli, RtcpReceiverReport, RtcpRemb,
                  RtcpSenderReport, RtcpTwcc, RtpPacket, is_rtcp,
                  pack_twcc_seq, parse_rtcp)
from .sctp import DataChannel, SctpAssociation
from .sdp import (MediaSection, SessionDescription, default_audio_codecs,
                  default_video_codecs)
from .srtp import SrtpContext, srtp_pair_from_dtls

logger = logging.getLogger("selkies_tpu_torch.webrtc.pc")

VIDEO_PT = 102
AUDIO_PT = 111
VIDEO_CLOCK = 90000
TWCC_EXT_ID = 2          # matches the a=extmap we offer in _describe
TWCC_HISTORY = 2048      # sent-packet records kept for feedback matching


class MediaSender:
    """One outbound RTP stream (externally encoded payloads in)."""

    def __init__(self, pc: "PeerConnection", kind: str, ssrc: int,
                 payload_type: int, clock_rate: int):
        self.pc = pc
        self.kind = kind
        self.ssrc = ssrc
        self.payload_type = payload_type
        self.clock_rate = clock_rate
        self.sequence = struct.unpack("!H", os.urandom(2))[0]
        self.packet_count = 0
        self.octet_count = 0
        self._payloader = H264Payloader() if kind == "video" \
            else OpusPayloader()
        self._last_rtp_ts: Optional[int] = None
        self._last_send_wall: float = 0.0
        #: recent wire packets for NACK retransmission (seq -> raw RTP)
        self._sent: Dict[int, bytes] = {}
        self._fec: Optional[UlpFecEncoder] = None

    def enable_fec(self, percentage: int) -> None:
        """RED+ULPFEC on this (video) stream, FEC overhead ≈ percentage of
        media packets (reference: ulpfec percentage,
        legacy/gstwebrtc_app.py:996-1000). 0 disables."""
        self._fec = UlpFecEncoder(percentage) if percentage > 0 else None

    def send_frame(self, payload: bytes, timestamp: int) -> None:
        """Packetize + protect + ship one encoded frame/AU."""
        packets = self._payloader.packetize(
            payload, self.ssrc, self.payload_type, self.sequence, timestamp)
        self.sequence = (self.sequence + len(packets)) & 0xFFFF
        self._last_rtp_ts = timestamp & 0xFFFFFFFF
        self._last_send_wall = time.time()
        # FEC rides only when the negotiated remote description includes
        # red+ulpfec — a peer that remapped or rejected them must get
        # plain media, not PT-103 packets it never agreed to
        red_pt = self.pc._red_pt
        ulpfec_pt = self.pc._ulpfec_pt
        fec = self._fec if (red_pt is not None
                            and ulpfec_pt is not None) else None
        for pkt in packets:
            # transport-wide sequencing feeds the sender-side GCC estimator
            pkt.extensions[TWCC_EXT_ID] = pack_twcc_seq(self.pc._next_twcc())
            if fec is None:
                self._ship(pkt.sequence_number, pkt.serialize(),
                           len(pkt.payload))
                continue
            # FEC protects the packet in its media form; the wire carries
            # the RED-encapsulated twin (same header, RED PT, 1-byte block
            # header) — matching libwebrtc's RED/ULPFEC arrangement.
            media_raw = pkt.serialize()
            fec_payload = fec.push(media_raw)
            inner = pkt.payload
            pkt.payload_type = red_pt
            pkt.payload = red_wrap(self.payload_type, inner)
            self._ship(pkt.sequence_number, pkt.serialize(), len(inner))
            if fec_payload is not None:
                self._send_fec(fec_payload, timestamp, red_pt, ulpfec_pt)

    def _send_fec(self, fec_payload: bytes, timestamp: int,
                  red_pt: int, ulpfec_pt: int) -> None:
        seq = self.sequence
        self.sequence = (self.sequence + 1) & 0xFFFF
        pkt = RtpPacket(
            payload_type=red_pt, sequence_number=seq,
            timestamp=timestamp & 0xFFFFFFFF, ssrc=self.ssrc,
            payload=red_wrap(ulpfec_pt, fec_payload))
        pkt.extensions[TWCC_EXT_ID] = pack_twcc_seq(self.pc._next_twcc())
        self._ship(seq, pkt.serialize(), len(pkt.payload))

    def _ship(self, seq: int, raw: bytes, payload_len: int) -> None:
        self.packet_count += 1
        self.octet_count += payload_len
        self._sent[seq] = raw
        while len(self._sent) > 512:
            # dicts are insertion-ordered: drop the oldest send, which
            # survives sequence wraparound (a numeric sort would evict
            # the NEWEST packets right after a wrap)
            del self._sent[next(iter(self._sent))]
        self.pc._send_rtp(raw)

    def resend(self, sequence_numbers) -> int:
        """NACK retransmission from the recent-packet buffer."""
        n = 0
        for seq in sequence_numbers:
            raw = self._sent.get(seq & 0xFFFF)
            if raw is not None:
                # no TWCC re-record: the cached packet carries its original
                # transport seq, and stamping the resend against the live
                # counter would corrupt the estimator's send-time table
                self.pc._send_rtp(raw, record_twcc=False)
                n += 1
        return n

    def sender_report(self, now_wall: float) -> Optional[RtcpSenderReport]:
        """SR with an honest NTP↔RTP mapping: the receiver uses this pair
        for A/V sync, so rtp_time must extrapolate the timestamps actually
        stamped on media packets, not an unrelated clock."""
        if self._last_rtp_ts is None:
            return None
        rtp_now = (self._last_rtp_ts + int(
            (now_wall - self._last_send_wall) * self.clock_rate)) & 0xFFFFFFFF
        ntp = int((now_wall + 2208988800) * (1 << 32)) & 0xFFFFFFFFFFFFFFFF
        return RtcpSenderReport(
            ssrc=self.ssrc, ntp_time=ntp, rtp_time=rtp_now,
            packet_count=self.packet_count, octet_count=self.octet_count)


class MediaReceiver:
    """One inbound RTP stream: jitter buffer → depayloader → frames."""

    def __init__(self, kind: str):
        self.kind = kind
        self.jitter = JitterBuffer()
        self.depayloader = H264Depayloader() if kind == "video" \
            else OpusDepayloader()
        self.on_frame: Optional[Callable[[bytes, int], None]] = None
        self.last_ssrc = 0
        self.packets = 0
        self.fec = UlpFecDecoder()
        #: negotiated ulpfec PT (updated from the remote description)
        self.ulpfec_pt = ULPFEC_PT

    def feed(self, packet: RtpPacket) -> None:
        self.last_ssrc = packet.ssrc
        self.packets += 1
        if self.kind == "audio":
            if self.on_frame is not None:
                self.on_frame(self.depayloader.feed(packet), packet.timestamp)
            return
        for pkt in self.jitter.add(packet):
            if pkt.payload_type == self.ulpfec_pt:
                continue      # seq-space placeholder (see feed_red)
            frame = self.depayloader.feed(pkt)
            if frame is not None and self.on_frame is not None:
                self.on_frame(frame, pkt.timestamp)

    def feed_red(self, packet: RtpPacket) -> None:
        """RED-encapsulated input: unwrap blocks, route ULPFEC payloads to
        the recovery cache, media blocks to the normal path, and feed any
        packets FEC can now reconstruct."""
        for pt, data in red_unwrap(packet.payload):
            if pt == self.ulpfec_pt:
                self.fec.add_fec(data)
                # FEC packets share the media sequence space (RFC 5109
                # with RED) — run an empty placeholder through the jitter
                # buffer so its seq doesn't head-of-line block the stream
                self.feed(RtpPacket(
                    payload_type=self.ulpfec_pt,
                    sequence_number=packet.sequence_number,
                    timestamp=packet.timestamp, ssrc=packet.ssrc))
                continue
            media = RtpPacket(
                payload_type=pt, sequence_number=packet.sequence_number,
                timestamp=packet.timestamp, ssrc=packet.ssrc,
                payload=data, marker=packet.marker,
                csrc=list(packet.csrc), extensions=dict(packet.extensions))
            self.fec.add_media(media.serialize())
            self.feed(media)
        for raw in self.fec.try_recover(packet.ssrc):
            try:
                self.feed(RtpPacket.parse(raw))
            except ValueError:
                continue


class PeerConnection:
    def __init__(
        self,
        certificate: Optional[DtlsCertificate] = None,
        stun_server: Optional[Tuple[str, int]] = None,
        interfaces: Optional[List[str]] = None,
    ):
        self.cert = certificate or DtlsCertificate.generate()
        self._stun_server = stun_server
        self._interfaces = interfaces
        self.ice: Optional[IceAgent] = None
        self.dtls: Optional[DtlsEndpoint] = None
        self.sctp: Optional[SctpAssociation] = None
        self.srtp_tx: Optional[SrtpContext] = None
        self.srtp_rx: Optional[SrtpContext] = None
        self.gcc = GccEstimator()
        self._twcc_seq = 0
        self._twcc_sent: Dict[int, Tuple[float, int]] = {}  # seq -> (ms, size)
        self._twcc_recv: Dict[int, int] = {}   # seq -> arrival (µs)
        self._nacked: Dict[int, float] = {}    # wire seq -> last NACK time
        self._twcc_fb_count = 0
        self._twcc_recv_ssrc = 0

        self.senders: Dict[int, MediaSender] = {}      # ssrc -> sender
        self.receivers: Dict[int, MediaReceiver] = {}  # payload type -> recv
        self.on_channel: Optional[Callable[[DataChannel], None]] = None
        self.on_bitrate: Optional[Callable[[int], None]] = None
        self.on_keyframe_request: Optional[Callable[[], None]] = None

        self.is_offerer: Optional[bool] = None
        # payload types as negotiated by the remote description; media PTs
        # start at our defaults, RED/ULPFEC stay None until a remote
        # description that includes both arrives
        self._video_pt = VIDEO_PT
        self._audio_pt = AUDIO_PT
        self._red_pt: Optional[int] = None
        self._ulpfec_pt: Optional[int] = None
        self._local_desc: Optional[SessionDescription] = None
        self._remote_desc: Optional[SessionDescription] = None
        self._pending_channels: List[Tuple[str, dict]] = []
        self._connected = asyncio.Event()
        self._closed = False
        self._run_task: Optional[asyncio.Task] = None
        self._want_data_section = False

    # ------------------------------------------------------------ tracks

    def add_video_sender(self, ssrc: Optional[int] = None) -> MediaSender:
        ssrc = ssrc or struct.unpack("!I", os.urandom(4))[0]
        s = MediaSender(self, "video", ssrc, self._video_pt, VIDEO_CLOCK)
        self.senders[ssrc] = s
        return s

    def add_audio_sender(self, ssrc: Optional[int] = None) -> MediaSender:
        ssrc = ssrc or struct.unpack("!I", os.urandom(4))[0]
        s = MediaSender(self, "audio", ssrc, self._audio_pt, 48000)
        self.senders[ssrc] = s
        return s

    def video_receiver(self) -> MediaReceiver:
        recv = self.receivers.setdefault(self._video_pt,
                                         MediaReceiver("video"))
        if self._ulpfec_pt is not None:
            recv.ulpfec_pt = self._ulpfec_pt
        return recv

    def audio_receiver(self) -> MediaReceiver:
        return self.receivers.setdefault(self._audio_pt,
                                         MediaReceiver("audio"))

    def create_data_channel(self, label: str, protocol: str = "",
                            ordered: bool = True,
                            max_retransmits: Optional[int] = None
                            ) -> "DataChannelHandle":
        self._want_data_section = True
        handle = DataChannelHandle(label, protocol, ordered, max_retransmits)
        self._pending_channels.append(handle)
        if self.sctp is not None and self.sctp.state == "established":
            handle.bind(self.sctp)
        return handle

    # -------------------------------------------------------------- JSEP

    async def create_offer(self) -> str:
        self.is_offerer = True
        await self._ensure_ice(controlling=True)
        self._local_desc = self._describe(setup="actpass")
        return self._local_desc.serialize()

    async def create_answer(self) -> str:
        if self._remote_desc is None:
            raise RuntimeError("set_remote_description first")
        self.is_offerer = False
        await self._ensure_ice(controlling=False)
        self._local_desc = self._describe(setup="active")
        self._start_transport()
        return self._local_desc.serialize()

    async def set_remote_description(self, sdp: str, sdp_type: str) -> None:
        self._remote_desc = SessionDescription.parse(sdp)
        media = self._remote_desc.media
        if not media:
            self._remote_desc = None
            raise ValueError("no media sections")
        if not any(m.dtls_fingerprint for m in media):
            # Fail closed up front (also re-checked in _start_transport):
            # an unpinned DTLS handshake would be open to on-path MITM.
            self._remote_desc = None
            raise ValueError(
                "remote description carries no DTLS fingerprint "
                "(session- or media-level a=fingerprint required)")
        m0 = media[0]
        self._negotiate_fec()
        if self.ice is not None:
            if m0.ice_ufrag and m0.ice_pwd:
                self.ice.set_remote_credentials(m0.ice_ufrag, m0.ice_pwd)
            for m in media:
                for cand in m.candidates:
                    self.ice.add_remote_candidate(cand)
        if sdp_type == "answer" and self.is_offerer:
            self._start_transport()

    def _negotiate_fec(self) -> None:
        """Adopt the remote description's payload-type numbering.

        Fixed constants broke any peer that remaps PTs: its media at the
        remapped PT would never reach a receiver and our sends would carry
        a PT it never agreed to. Applies to the media codecs (H264, opus)
        and to RED/ULPFEC — the FEC pair must BOTH be present in the
        remote video section for the RED path to engage at all."""
        self._red_pt = self._ulpfec_pt = None
        if self._remote_desc is None:
            return

        def _adopt(kind: str, codec_name: str, current: int) -> int:
            section = next((m for m in self._remote_desc.media
                            if m.kind == kind), None)
            if section is None:
                return current
            matches = [c for c in section.codecs
                       if c.name.lower() == codec_name]
            if codec_name == "h264" and len(matches) > 1:
                # browsers offer several H264 entries differing in
                # packetization-mode/profile; this stack sends FU-A
                # fragmented mode-1 constrained-baseline, so prefer the
                # entry that actually denotes that arrangement (RFC 6184:
                # absent packetization-mode means single-NAL mode 0)
                def rank(c):
                    fmtp = c.fmtp or ""
                    mode1 = "packetization-mode=1" in fmtp
                    baseline = "profile-level-id=42" in fmtp
                    return (mode1, baseline)
                matches.sort(key=rank, reverse=True)
            if (codec_name == "h264" and matches
                    and "packetization-mode=1" not in (matches[0].fmtp or "")):
                # we still emit FU-A at this PT; a strict single-NAL
                # (mode-0) receiver cannot parse fragmented units
                logger.warning(
                    "remote offers no packetization-mode=1 H264 entry "
                    "(using pt=%d); FU-A fragments may not decode on "
                    "a strict mode-0 receiver",
                    matches[0].payload_type)
            pt = matches[0].payload_type if matches else None
            if pt is None or pt == current:
                return current
            # re-key the receiver and re-stamp senders of this kind
            recv = self.receivers.pop(current, None)
            if recv is not None:
                self.receivers[pt] = recv
            for s in self.senders.values():
                if s.kind == kind:
                    s.payload_type = pt
            return pt

        self._video_pt = _adopt("video", "h264", self._video_pt)
        self._audio_pt = _adopt("audio", "opus", self._audio_pt)
        video = next((m for m in self._remote_desc.media
                      if m.kind == "video"), None)
        if video is None:
            return
        for c in video.codecs:
            if c.name.lower() == "red":
                self._red_pt = c.payload_type
            elif c.name.lower() == "ulpfec":
                self._ulpfec_pt = c.payload_type
        if self._red_pt is None or self._ulpfec_pt is None:
            self._red_pt = self._ulpfec_pt = None
            return
        recv = self.receivers.get(self._video_pt)
        if recv is not None:
            recv.ulpfec_pt = self._ulpfec_pt

    def add_ice_candidate(self, candidate_sdp: str) -> None:
        if self.ice is not None:
            self.ice.add_remote_candidate(Candidate.from_sdp(candidate_sdp))

    async def wait_connected(self, timeout: float = 15.0) -> None:
        await asyncio.wait_for(self._connected.wait(), timeout)

    # ---------------------------------------------------------- internals

    async def _ensure_ice(self, controlling: bool) -> None:
        if self.ice is not None:
            return
        self.ice = IceAgent(controlling=controlling,
                            stun_server=self._stun_server,
                            interfaces=self._interfaces)
        await self.ice.gather()
        self.ice.on_data = self._ice_data
        if self._remote_desc is not None:
            m0 = self._remote_desc.media[0]
            if m0.ice_ufrag and m0.ice_pwd:
                self.ice.set_remote_credentials(m0.ice_ufrag, m0.ice_pwd)
            for m in self._remote_desc.media:
                for cand in m.candidates:
                    self.ice.add_remote_candidate(cand)

    def _describe(self, setup: str) -> SessionDescription:
        mids = []
        media = []
        fingerprint = self.cert.fingerprint()
        common = dict(
            ice_ufrag=self.ice.local_ufrag, ice_pwd=self.ice.local_pwd,
            dtls_fingerprint=fingerprint, dtls_setup=setup,
            candidates=list(self.ice.local_candidates),
            end_of_candidates=True)
        video_ssrc = next((s.ssrc for s in self.senders.values()
                           if s.kind == "video"), None)
        audio_ssrc = next((s.ssrc for s in self.senders.values()
                           if s.kind == "audio"), None)
        video_codecs = default_video_codecs()
        audio_codecs = default_audio_codecs()
        if self._remote_desc is not None:
            # answering: an answer may only contain codecs the offer holds
            # — drop red/ulpfec when the remote didn't offer them, and
            # adopt the remote's PT numbering throughout
            for c in video_codecs:
                if c.name == "H264":
                    c.payload_type = self._video_pt
                elif c.name == "red" and self._red_pt is not None:
                    c.payload_type = self._red_pt
                elif c.name == "ulpfec" and self._ulpfec_pt is not None:
                    c.payload_type = self._ulpfec_pt
            for c in audio_codecs:
                if c.name == "opus":
                    c.payload_type = self._audio_pt
            if self._red_pt is None:
                video_codecs = [c for c in video_codecs
                                if c.name not in ("red", "ulpfec")]
        mid = 0
        media.append(MediaSection(
            kind="video", mid=str(mid), codecs=video_codecs,
            ssrc=video_ssrc, cname="selkies-tpu",
            msid="selkies video0", direction="sendrecv", **common))
        mids.append(str(mid)); mid += 1
        media.append(MediaSection(
            kind="audio", mid=str(mid), codecs=audio_codecs,
            ssrc=audio_ssrc, cname="selkies-tpu",
            msid="selkies audio0", direction="sendrecv", **common))
        mids.append(str(mid)); mid += 1
        if self._want_data_section or (
                self._remote_desc is not None and any(
                    m.kind == "application" for m in self._remote_desc.media)):
            media.append(MediaSection(
                kind="application", mid=str(mid),
                protocol="UDP/DTLS/SCTP", sctp_port=5000,
                max_message_size=262144, **common))
            mids.append(str(mid))
        return SessionDescription(
            session_id=struct.unpack("!I", os.urandom(4))[0],
            media=media, bundle=mids)

    def _start_transport(self) -> None:
        remote_fp = next(
            (m.dtls_fingerprint for m in self._remote_desc.media
             if m.dtls_fingerprint), None)
        if remote_fp is None:
            # Fail closed: without a pinned fingerprint the DTLS layer
            # would complete unauthenticated, opening media and the input
            # data channel to an on-path MITM.
            raise ValueError(
                "remote description carries no DTLS fingerprint "
                "(session- or media-level a=fingerprint required)")
        # offerer offered actpass; answerer is active (DTLS client)
        is_dtls_client = not self.is_offerer
        self.dtls = DtlsEndpoint(
            is_client=is_dtls_client, certificate=self.cert,
            on_send=self._dtls_send, remote_fingerprint=remote_fp)
        self.dtls.on_data = self._dtls_app_data
        want_sctp = any(m.kind == "application"
                        for m in self._remote_desc.media) \
            or self._want_data_section
        if want_sctp:
            self.sctp = SctpAssociation(
                is_client=is_dtls_client,
                on_send=lambda d: self.dtls.send_app_data(d))
            self.sctp.on_channel = self._sctp_channel
        self._run_task = asyncio.create_task(self._run())

    async def _run(self) -> None:
        try:
            await self.ice.connect()
        except Exception as exc:
            logger.error("ICE failed: %s", exc)
            return
        self.dtls.start()
        # drive DTLS to completion
        for _ in range(600):
            if self.dtls.handshake_complete or self.dtls.handshake_failed:
                break
            self.dtls.check_retransmit()
            await asyncio.sleep(0.02)
        if not self.dtls.handshake_complete:
            logger.error("DTLS failed: %s", self.dtls.handshake_failed)
            return
        keying = self.dtls.export_srtp()
        self.srtp_tx, self.srtp_rx = srtp_pair_from_dtls(
            keying, is_client=self.dtls.is_client)
        if self.sctp is not None:
            self.sctp.start()
        self._connected.set()
        last_sr = 0.0
        while not self._closed:
            now = time.monotonic()
            if self.sctp is not None:
                self.sctp.check_retransmit(now)
                for handle in self._pending_channels:
                    if not handle.bound and self.sctp.state == "established":
                        handle.bind(self.sctp)
            if now - last_sr > 2.0 and self.srtp_tx is not None:
                last_sr = now
                self._send_sender_reports(now)
            if self._twcc_recv and self.srtp_tx is not None:
                self._send_twcc_feedback()
            self._send_nacks()
            await asyncio.sleep(0.05)

    # ------------------------------------------------------------- demux

    def _ice_data(self, data: bytes) -> None:
        if not data:
            return
        b0 = data[0]
        if 20 <= b0 <= 63:
            self.dtls and self.dtls.receive(data)
        elif 128 <= b0 <= 191 and self.srtp_rx is not None:
            if is_rtcp(data):
                self._handle_rtcp(data)
            else:
                self._handle_rtp(data)

    def _handle_rtp(self, data: bytes) -> None:
        try:
            plain = self.srtp_rx.unprotect_rtp(data)
        except ValueError:
            return
        try:
            pkt = RtpPacket.parse(plain)
        except ValueError:
            return
        ext = pkt.extensions.get(TWCC_EXT_ID)
        if ext is not None and len(ext) == 2:
            seq = int.from_bytes(ext, "big")
            self._twcc_recv[seq] = int(time.monotonic() * 1e6)
            self._twcc_recv_ssrc = pkt.ssrc
        if self._red_pt is not None and pkt.payload_type == self._red_pt:
            self.video_receiver().feed_red(pkt)
            return
        recv = self.receivers.get(pkt.payload_type)
        if recv is not None:
            recv.feed(pkt)

    def _next_twcc(self) -> int:
        seq = self._twcc_seq
        self._twcc_seq = (self._twcc_seq + 1) & 0xFFFF
        return seq

    def _record_twcc_send(self, seq: int, size: int) -> None:
        self._twcc_sent[seq] = (time.monotonic() * 1000.0, size)
        # Evict in insertion order (dicts preserve it): numeric order would
        # drop the *newest* entries right after the 16-bit seq wrap.
        while len(self._twcc_sent) > TWCC_HISTORY:
            del self._twcc_sent[next(iter(self._twcc_sent))]

    def _handle_rtcp(self, data: bytes) -> None:
        try:
            plain = self.srtp_rx.unprotect_rtcp(data)
        except ValueError:
            return
        for pkt in parse_rtcp(plain):
            if isinstance(pkt, RtcpPli) and self.on_keyframe_request:
                self.on_keyframe_request()
            elif isinstance(pkt, RtcpReceiverReport):
                for r in pkt.reports:
                    self.gcc.add_loss_report(r.fraction_lost / 256.0)
                if self.on_bitrate:
                    self.on_bitrate(self.gcc.bitrate)
            elif isinstance(pkt, RtcpTwcc):
                self.gcc.feed_twcc(pkt.received, self._twcc_sent)
                if self.on_bitrate:
                    self.on_bitrate(self.gcc.bitrate)
            elif isinstance(pkt, RtcpRemb):
                self.gcc.feed_remb(pkt.bitrate)
                if self.on_bitrate:
                    self.on_bitrate(self.gcc.bitrate)
            elif isinstance(pkt, RtcpNack):
                sender = self.senders.get(pkt.media_ssrc)
                if sender is not None:
                    sender.resend(pkt.lost)

    def _dtls_send(self, data: bytes) -> None:
        try:
            self.ice.send(data)
        except ConnectionError:
            pass

    def _dtls_app_data(self, data: bytes) -> None:
        if self.sctp is not None:
            self.sctp.receive(data)

    def _send_rtp(self, raw: bytes, record_twcc: bool = True) -> None:
        if self.srtp_tx is None:
            return
        if record_twcc:
            # record the just-assigned transport seq against the wire size
            self._record_twcc_send((self._twcc_seq - 1) & 0xFFFF, len(raw))
        try:
            self.ice.send(self.srtp_tx.protect_rtp(raw))
        except ConnectionError:
            pass

    def _send_sender_reports(self, now: float) -> None:
        del now  # monotonic; SR mapping needs the wall clock
        wall = time.time()
        for s in self.senders.values():
            sr = s.sender_report(wall)
            if sr is None:
                continue
            try:
                self.ice.send(self.srtp_tx.protect_rtcp(sr.serialize()))
            except (ConnectionError, ValueError):
                pass

    def _send_nacks(self) -> None:
        """Request retransmission of jitter-buffer gaps (video only; audio
        rides concealment)."""
        recv = self.receivers.get(self._video_pt)
        if recv is None or self.srtp_tx is None:
            return
        missing = recv.jitter.missing()
        if not missing or len(missing) > 64:   # burst loss → PLI instead
            if missing and recv.last_ssrc:
                self.request_keyframe(recv.last_ssrc)
                recv.jitter.skip_all()
            return
        # per-seq holdoff: re-NACK only after the retransmission had a
        # chance to arrive, or duplicates flood exactly when the path hurts
        now = time.monotonic()
        due = [s for s in missing
               if now - self._nacked.get(s, 0.0) > 0.25]
        if not due:
            return
        for s in due:
            self._nacked[s] = now
        if len(self._nacked) > 1024:
            self._nacked = {s: t for s, t in self._nacked.items()
                            if now - t < 2.0}
        nack = RtcpNack(sender_ssrc=1, media_ssrc=recv.last_ssrc, lost=due)
        try:
            self.ice.send(self.srtp_tx.protect_rtcp(nack.serialize()))
        except (ConnectionError, ValueError):
            pass

    def _send_twcc_feedback(self) -> None:
        """Ship transport-wide-cc feedback for packets received since the
        last report (the signal the remote GCC estimator runs on)."""
        recv, self._twcc_recv = self._twcc_recv, {}
        seqs = sorted(recv)
        base = seqs[0]
        span = (seqs[-1] - base) & 0xFFFF
        if span > 500:   # wrap/garbage guard: report the head run only
            seqs = [s for s in seqs if ((s - base) & 0xFFFF) <= 500]
            span = (seqs[-1] - base) & 0xFFFF
        received = [((base + i) & 0xFFFF, recv.get((base + i) & 0xFFFF))
                    for i in range(span + 1)]
        ref_us = min(t for _, t in received if t is not None)
        fb = RtcpTwcc(
            sender_ssrc=1, media_ssrc=self._twcc_recv_ssrc,
            base_seq=base, fb_count=self._twcc_fb_count & 0xFF,
            ref_time=(ref_us // 64000) & 0xFFFFFF,
            received=received)
        self._twcc_fb_count += 1
        try:
            self.ice.send(self.srtp_tx.protect_rtcp(fb.serialize()))
        except (ConnectionError, ValueError):
            pass

    def request_keyframe(self, media_ssrc: int) -> None:
        if self.srtp_tx is None:
            return
        pli = RtcpPli(sender_ssrc=1, media_ssrc=media_ssrc)
        try:
            self.ice.send(self.srtp_tx.protect_rtcp(pli.serialize()))
        except ConnectionError:
            pass

    def _sctp_channel(self, ch: DataChannel) -> None:
        if self.on_channel is not None:
            self.on_channel(ch)

    async def close(self) -> None:
        self._closed = True
        if self._run_task is not None:
            self._run_task.cancel()
        if self.ice is not None:
            await self.ice.close()


class DataChannelHandle:
    """Pre-negotiation handle; binds to the SCTP association once up."""

    def __init__(self, label: str, protocol: str, ordered: bool,
                 max_retransmits: Optional[int]):
        self.label = label
        self.protocol = protocol
        self.ordered = ordered
        self.max_retransmits = max_retransmits
        self.channel: Optional[DataChannel] = None
        self.on_message: Optional[Callable[[bytes], None]] = None
        self.on_open: Optional[Callable[[], None]] = None
        self._sctp: Optional[SctpAssociation] = None

    @property
    def bound(self) -> bool:
        return self.channel is not None

    @property
    def open(self) -> bool:
        return self.channel is not None and self.channel.open

    def bind(self, sctp: SctpAssociation) -> None:
        self._sctp = sctp
        self.channel = sctp.create_channel(
            self.label, self.protocol, self.ordered, self.max_retransmits)
        self.channel.on_message = lambda d: self.on_message and self.on_message(d)
        self.channel.on_open = lambda: self.on_open and self.on_open()

    def send(self, data) -> None:
        if not self.open:
            raise ConnectionError("channel not open")
        self._sctp.send(self.channel, data)

"""SDP parse/serialize — the JSEP subset the streaming plane needs.

Role parity with the vendored ``src/selkies/webrtc/sdp.py`` (617 LoC,
SURVEY.md §2.4), redesigned as plain dataclasses: bundle-capable audio +
video media sections with ICE credentials/candidates, DTLS fingerprint +
setup role, RTP codec maps with fmtp/rtcp-fb, header extensions, and data
channel (SCTP) sections.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from .ice import Candidate


@dataclass
class RtpCodec:
    payload_type: int
    name: str
    clock_rate: int
    channels: Optional[int] = None
    fmtp: Optional[str] = None
    rtcp_fb: List[str] = field(default_factory=list)

    @property
    def rtpmap(self) -> str:
        base = f"{self.name}/{self.clock_rate}"
        return base + (f"/{self.channels}" if self.channels else "")


@dataclass
class MediaSection:
    kind: str                       # audio | video | application
    mid: str = "0"
    port: int = 9
    protocol: str = "UDP/TLS/RTP/SAVPF"
    direction: str = "sendrecv"
    codecs: List[RtpCodec] = field(default_factory=list)
    ssrc: Optional[int] = None
    cname: Optional[str] = None
    msid: Optional[str] = None
    ice_ufrag: Optional[str] = None
    ice_pwd: Optional[str] = None
    ice_lite: bool = False
    candidates: List[Candidate] = field(default_factory=list)
    end_of_candidates: bool = False
    dtls_fingerprint: Optional[str] = None   # "sha-256 AB:CD:..."
    dtls_setup: Optional[str] = None         # actpass | active | passive
    extmap: Dict[int, str] = field(default_factory=dict)
    sctp_port: Optional[int] = None
    max_message_size: Optional[int] = None
    rtcp_mux: bool = True


@dataclass
class SessionDescription:
    session_id: int = 1
    media: List[MediaSection] = field(default_factory=list)
    bundle: List[str] = field(default_factory=list)

    # ------------------------------------------------------------ serialize

    def serialize(self) -> str:
        lines = [
            "v=0",
            f"o=- {self.session_id} 2 IN IP4 127.0.0.1",
            "s=-",
            "t=0 0",
        ]
        if self.bundle:
            lines.append("a=group:BUNDLE " + " ".join(self.bundle))
        lines.append("a=msid-semantic: WMS *")
        for m in self.media:
            lines += self._media_lines(m)
        return "\r\n".join(lines) + "\r\n"

    @staticmethod
    def _media_lines(m: MediaSection) -> List[str]:
        if m.kind == "application":
            fmt = "webrtc-datachannel"
        else:
            fmt = " ".join(str(c.payload_type) for c in m.codecs)
        lines = [f"m={m.kind} {m.port} {m.protocol} {fmt}",
                 "c=IN IP4 0.0.0.0"]
        if m.kind != "application":
            lines.append("a=rtcp:9 IN IP4 0.0.0.0")
        if m.ice_ufrag:
            lines.append(f"a=ice-ufrag:{m.ice_ufrag}")
        if m.ice_pwd:
            lines.append(f"a=ice-pwd:{m.ice_pwd}")
        if m.ice_lite:
            lines.append("a=ice-lite")
        if m.dtls_fingerprint:
            lines.append(f"a=fingerprint:{m.dtls_fingerprint}")
        if m.dtls_setup:
            lines.append(f"a=setup:{m.dtls_setup}")
        lines.append(f"a=mid:{m.mid}")
        for ext_id, uri in sorted(m.extmap.items()):
            lines.append(f"a=extmap:{ext_id} {uri}")
        if m.kind != "application":
            lines.append(f"a={m.direction}")
            if m.rtcp_mux:
                lines.append("a=rtcp-mux")
            for c in m.codecs:
                lines.append(f"a=rtpmap:{c.payload_type} {c.rtpmap}")
                for fb in c.rtcp_fb:
                    lines.append(f"a=rtcp-fb:{c.payload_type} {fb}")
                if c.fmtp:
                    lines.append(f"a=fmtp:{c.payload_type} {c.fmtp}")
            if m.ssrc is not None:
                if m.msid:
                    lines.append(f"a=ssrc:{m.ssrc} msid:{m.msid}")
                lines.append(f"a=ssrc:{m.ssrc} cname:{m.cname or 'selkies'}")
        else:
            lines.append(f"a=sctp-port:{m.sctp_port or 5000}")
            if m.max_message_size:
                lines.append(f"a=max-message-size:{m.max_message_size}")
        for cand in m.candidates:
            lines.append("a=" + cand.to_sdp())
        if m.end_of_candidates:
            lines.append("a=end-of-candidates")
        return lines

    # ------------------------------------------------------------ parse

    @classmethod
    def parse(cls, text: str) -> "SessionDescription":
        desc = cls(media=[])
        current: Optional[MediaSection] = None
        # Session-level attributes (before the first m= line) are defaults
        # for every media section — Firefox in particular puts
        # a=fingerprint at session level, and dropping it would leave the
        # DTLS layer with no fingerprint to pin.
        session = MediaSection(kind="session", codecs=[])
        for raw in text.replace("\r\n", "\n").split("\n"):
            line = raw.strip()
            if not line:
                continue
            if line.startswith("o="):
                try:
                    desc.session_id = int(line.split()[1])
                except (IndexError, ValueError):
                    pass
            elif line.startswith("m="):
                parts = line[2:].split()
                current = MediaSection(kind=parts[0], port=int(parts[1]),
                                       protocol=parts[2], codecs=[])
                desc.media.append(current)
            elif line.startswith("a="):
                desc._attr(current if current is not None else session,
                           line[2:])
        for m in desc.media:
            if m.ice_ufrag is None:
                m.ice_ufrag = session.ice_ufrag
            if m.ice_pwd is None:
                m.ice_pwd = session.ice_pwd
            if m.dtls_fingerprint is None:
                m.dtls_fingerprint = session.dtls_fingerprint
            if m.dtls_setup is None:
                m.dtls_setup = session.dtls_setup
            m.ice_lite = m.ice_lite or session.ice_lite
        return desc

    def _attr(self, m: Optional[MediaSection], attr: str) -> None:
        key, _, value = attr.partition(":")
        if key == "group" and value.startswith("BUNDLE"):
            self.bundle = value.split()[1:]
            return
        if m is None:
            return
        if key == "mid":
            m.mid = value
        elif key == "ice-ufrag":
            m.ice_ufrag = value
        elif key == "ice-pwd":
            m.ice_pwd = value
        elif key == "ice-lite":
            m.ice_lite = True
        elif key == "fingerprint":
            m.dtls_fingerprint = value
        elif key == "setup":
            m.dtls_setup = value
        elif key == "rtcp-mux":
            m.rtcp_mux = True
        elif key == "sctp-port":
            m.sctp_port = int(value)
        elif key == "max-message-size":
            m.max_message_size = int(value)
        elif key in ("sendrecv", "sendonly", "recvonly", "inactive"):
            m.direction = key
        elif key == "extmap":
            parts = value.split()
            m.extmap[int(parts[0].split("/")[0])] = parts[1]
        elif key == "rtpmap":
            pt_s, _, map_s = value.partition(" ")
            bits = map_s.split("/")
            codec = RtpCodec(
                payload_type=int(pt_s), name=bits[0],
                clock_rate=int(bits[1]),
                channels=int(bits[2]) if len(bits) > 2 else None)
            m.codecs.append(codec)
        elif key == "fmtp":
            pt_s, _, fmtp = value.partition(" ")
            for c in m.codecs:
                if c.payload_type == int(pt_s):
                    c.fmtp = fmtp
        elif key == "rtcp-fb":
            pt_s, _, fb = value.partition(" ")
            for c in m.codecs:
                if str(c.payload_type) == pt_s:
                    c.rtcp_fb.append(fb)
        elif key == "ssrc":
            parts = value.split(None, 1)
            try:
                m.ssrc = int(parts[0])
            except ValueError:
                return
            if len(parts) > 1:
                field_, _, fv = parts[1].partition(":")
                if field_ == "cname":
                    m.cname = fv
                elif field_ == "msid":
                    m.msid = fv
        elif key == "candidate":
            m.candidates.append(Candidate.from_sdp("candidate:" + value))
        elif key == "end-of-candidates":
            m.end_of_candidates = True


# Default codec maps matching the browser client's expectations
# (H.264 constrained-baseline packetization-mode=1 — what WebCodecs and
# webrtcbin negotiate in the reference, gstwebrtc_app.py:944-984).

def default_video_codecs() -> List[RtpCodec]:
    return [
        RtpCodec(
            payload_type=102, name="H264", clock_rate=90000,
            fmtp="level-asymmetry-allowed=1;packetization-mode=1;"
                 "profile-level-id=42e01f",
            rtcp_fb=["nack", "nack pli", "ccm fir", "goog-remb",
                     "transport-cc"]),
        # RED/ULPFEC (RFC 2198/5109) — negotiated so the browser's native
        # stack accepts the FEC-protected wire format (webrtc/fec.py)
        RtpCodec(payload_type=103, name="red", clock_rate=90000),
        RtpCodec(payload_type=104, name="ulpfec", clock_rate=90000),
    ]


def default_audio_codecs() -> List[RtpCodec]:
    return [RtpCodec(
        payload_type=111, name="opus", clock_rate=48000, channels=2,
        fmtp="minptime=10;useinbandfec=1", rtcp_fb=["transport-cc"])]

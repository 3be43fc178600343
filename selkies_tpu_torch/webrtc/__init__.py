"""The port's copy of the WebRTC stack (from ``selkies_tpu/webrtc``;
transport phase 2 of SURVEY.md §7).

The reference stages a vendored aiortc fork (``src/selkies/webrtc/``,
SURVEY.md §2.4) to carry externally-encoded H.264 over real WebRTC without
re-encoding. This package plays the same role for the encoder's bitstreams, built
from scratch on ``cryptography`` primitives (no pyav/pylibsrtp/aioice in
this environment):

  - :mod:`.rtp`        RTP/RTCP packetization (RFC 3550/4585/5104, TWCC, REMB)
  - :mod:`.h264`       Annex-B ↔ FU-A/STAP-A payloader/depayloader (RFC 6184)
  - :mod:`.opus`       Opus payloader (RFC 7587)
  - :mod:`.jitterbuffer` receive-side reorder/assembly
  - :mod:`.rate`       Google Congestion Control (trendline + AIMD)
  - :mod:`.stun`       STUN message codec (RFC 5389)
  - :mod:`.ice`        ICE agent (host candidates + connectivity checks)
  - :mod:`.sdp`        SDP parse/serialize (JSEP subset)
  - :mod:`.srtp`       SRTP/SRTCP protect/unprotect (RFC 3711)
  - :mod:`.dtls`       DTLS 1.2 handshake with use_srtp (RFC 5764)
  - :mod:`.sctp`       SCTP over DTLS + DCEP data channels (RFC 8831/8832)
"""

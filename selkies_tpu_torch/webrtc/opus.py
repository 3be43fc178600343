"""Opus RTP payloader/depayloader (RFC 7587).

One Opus frame per RTP packet; timestamps advance at 48 kHz regardless of
the coded bandwidth. Pairs with the audio subsystem's 20 ms Opus frames
(selkies_tpu_torch.audio.codec; reference pcmflux default, selkies.py:1008-1011).
"""

from __future__ import annotations

from typing import List

from .rtp import RtpPacket

OPUS_CLOCK = 48000


class OpusPayloader:
    def packetize(
        self, frame: bytes, ssrc: int, payload_type: int,
        sequence_number: int, timestamp: int,
    ) -> List[RtpPacket]:
        return [RtpPacket(
            payload_type=payload_type,
            sequence_number=sequence_number & 0xFFFF,
            timestamp=timestamp & 0xFFFFFFFF,
            ssrc=ssrc,
            payload=frame,
            marker=0,
        )]


class OpusDepayloader:
    def feed(self, packet: RtpPacket) -> bytes:
        return packet.payload

"""Per-display frame-ID backpressure (copy of ``selkies_tpu/server/backpressure.py``).

Behavioral port of the reference's desync loop (selkies.py:1165-1236 and
constants selkies.py:6-16): the server stamps outgoing video frames with a
u16 frame id; the client periodically ACKs the last id it decoded; if the
client falls more than ~2 s of frames behind (RTT-adjusted) or stops ACKing
for 4 s, sending is gated off until it recovers.

The decision logic lives in a pure, clock-injected class
(:class:`BackpressureState`) so it is unit-testable without asyncio; the
server wraps it in a task that ticks every ``CHECK_INTERVAL_S``.

On the TPU side this gate additionally suppresses encode dispatch for gated
displays (skip-frame under backpressure), saving device work — the analogue
of pixelflux simply not being read.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Deque, Optional

from collections import deque

from ..protocol.wire import FrameId

ALLOWED_DESYNC_MS = 2000
LATENCY_THRESHOLD_MS = 50
CHECK_INTERVAL_S = 0.5
STALLED_CLIENT_TIMEOUT_S = 4.0
RTT_SMOOTHING_SAMPLES = 20
SENT_TIMESTAMP_HISTORY = 1000


@dataclass
class BackpressureState:
    """Pure backpressure decision state for one display."""

    framerate: float = 60.0
    allowed_desync_ms: float = ALLOWED_DESYNC_MS
    latency_threshold_ms: float = LATENCY_THRESHOLD_MS

    last_sent_frame_id: int = 0
    acknowledged_frame_id: int = -1
    latest_client_fps: float = 0.0
    smoothed_rtt_ms: float = 0.0
    send_enabled: bool = True
    last_ack_time: float = field(default_factory=time.monotonic)

    _sent_timestamps: Deque = field(default_factory=lambda: deque(maxlen=SENT_TIMESTAMP_HISTORY))
    _rtt_samples: Deque = field(default_factory=lambda: deque(maxlen=RTT_SMOOTHING_SAMPLES))

    # -- sender side -------------------------------------------------------

    def on_frame_sent(self, frame_id: int, now: Optional[float] = None) -> None:
        self.last_sent_frame_id = frame_id & 0xFFFF
        self._sent_timestamps.append(
            (frame_id & 0xFFFF, time.monotonic() if now is None else now))

    # -- receiver side -----------------------------------------------------

    def on_client_ack(self, frame_id: int, now: Optional[float] = None) -> None:
        now = time.monotonic() if now is None else now
        self.acknowledged_frame_id = frame_id & 0xFFFF
        self.last_ack_time = now
        for fid, ts in reversed(self._sent_timestamps):
            if fid == self.acknowledged_frame_id:
                rtt_ms = max(0.0, (now - ts) * 1000.0)
                self._rtt_samples.append(rtt_ms)
                self.smoothed_rtt_ms = sum(self._rtt_samples) / len(self._rtt_samples)
                break

    def on_client_fps(self, fps: float) -> None:
        self.latest_client_fps = max(0.0, float(fps))

    def reset(self, now: Optional[float] = None) -> None:
        """PIPELINE_RESETTING semantics: ids restart, gate opens."""
        self.last_sent_frame_id = 0
        self.acknowledged_frame_id = -1
        self.send_enabled = True
        self.last_ack_time = time.monotonic() if now is None else now
        self._sent_timestamps.clear()

    # -- periodic decision -------------------------------------------------

    def evaluate(self, now: Optional[float] = None) -> bool:
        """Recompute ``send_enabled``; call every CHECK_INTERVAL_S."""
        now = time.monotonic() if now is None else now

        if self.acknowledged_frame_id == -1:
            # no ACK yet: open gate, don't count stall time
            self.send_enabled = True
            self.last_ack_time = now
            return self.send_enabled

        sent, acked = self.last_sent_frame_id, self.acknowledged_frame_id
        if FrameId.is_anomalous(sent, acked):
            # wrap-around anomaly: trust the client, reset posture
            self.send_enabled = True
            self.last_ack_time = now
            return self.send_enabled
        if sent == 0:
            return self.send_enabled

        fps = self.latest_client_fps or self.framerate or 60.0
        desync = FrameId.desync(sent, acked)
        allowed = (self.allowed_desync_ms / 1000.0) * fps
        adjust = (
            (self.smoothed_rtt_ms / 1000.0) * fps
            if self.smoothed_rtt_ms > self.latency_threshold_ms
            else 0.0
        )
        effective = desync - adjust

        if now - self.last_ack_time > STALLED_CLIENT_TIMEOUT_S:
            self.send_enabled = False
        elif effective > allowed:
            self.send_enabled = False
        else:
            self.send_enabled = True
        return self.send_enabled

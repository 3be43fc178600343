"""Google Congestion Control: delay-gradient + loss based rate estimation.

Replaces the reference's GStreamer ``rtpgccbwe`` element
(``legacy/gstwebrtc_app.py:1555-1572``), whose estimated-bitrate signal
feeds ``set_video_bitrate``; here the estimate feeds the encoder's rate
controller (quality/CRF clamps) and the REMB/TWCC feedback builders.

Structure follows the published GCC draft (draft-ietf-rmcat-gcc-02): an
arrival-time filter over packet groups, a linear-regression *trendline*
estimator of the queuing-delay slope, an overuse detector with adaptive
threshold, and an AIMD rate controller; a separate loss-based controller
takes over above 10% loss. Pure Python, deterministic, unit-testable —
no wall clock reads inside the algorithm (callers pass timestamps).
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Deque, List, Optional, Tuple

BURST_INTERVAL_MS = 5.0
TRENDLINE_WINDOW = 20
OVERUSE_TIME_TH_MS = 10.0
K_UP = 0.0087
K_DOWN = 0.039
ETA = 1.08            # multiplicative increase
ALPHA = 0.85          # decrease factor
MIN_BITRATE = 150_000
MAX_BITRATE = 40_000_000


@dataclass
class _Group:
    first_send_ms: float
    last_send_ms: float
    first_arrival_ms: float
    last_arrival_ms: float
    size: int


class TrendlineEstimator:
    """Slope of (arrival delta - send delta) accumulation over time."""

    def __init__(self, window: int = TRENDLINE_WINDOW):
        self.window = window
        self._history: Deque[Tuple[float, float]] = deque(maxlen=window)
        self._acc = 0.0
        self._first_arrival: Optional[float] = None
        self.trend = 0.0

    def update(self, recv_delta_ms: float, send_delta_ms: float,
               arrival_ms: float) -> float:
        delta = recv_delta_ms - send_delta_ms
        self._acc += delta
        if self._first_arrival is None:
            self._first_arrival = arrival_ms
        self._history.append((arrival_ms - self._first_arrival, self._acc))
        if len(self._history) >= self.window:
            xs = [h[0] for h in self._history]
            ys = [h[1] for h in self._history]
            n = len(xs)
            mx = sum(xs) / n
            my = sum(ys) / n
            den = sum((x - mx) ** 2 for x in xs)
            if den > 0:
                self.trend = sum(
                    (x - mx) * (y - my) for x, y in zip(xs, ys)) / den
        return self.trend


class OveruseDetector:
    """Adaptive-threshold comparison of the (gained) trend signal."""

    def __init__(self):
        self.threshold = 12.5
        self.state = "normal"          # normal | overuse | underuse
        self._overuse_start: Optional[float] = None
        self._last_update: Optional[float] = None

    def update(self, trend: float, n_deltas: int, now_ms: float) -> str:
        modified = trend * min(n_deltas, 60) * 4.0
        if self._last_update is not None:
            # adapt threshold toward |signal| (k_up/k_down asymmetric)
            k = K_DOWN if abs(modified) < self.threshold else K_UP
            dt = min(now_ms - self._last_update, 100.0)
            self.threshold += k * (abs(modified) - self.threshold) * dt
            self.threshold = min(max(self.threshold, 6.0), 600.0)
        self._last_update = now_ms

        if modified > self.threshold:
            if self._overuse_start is None:
                self._overuse_start = now_ms
            elif now_ms - self._overuse_start > OVERUSE_TIME_TH_MS:
                self.state = "overuse"
        elif modified < -self.threshold:
            self.state = "underuse"
            self._overuse_start = None
        else:
            self.state = "normal"
            self._overuse_start = None
        return self.state


class AimdRateController:
    def __init__(self, start_bitrate: int = 2_000_000):
        self.bitrate = start_bitrate
        self._state = "increase"       # increase | decrease | hold
        self._last_update: Optional[float] = None
        self._avg_max_bitrate: Optional[float] = None

    def update(self, state: str, incoming_bitrate: float, now_ms: float) -> int:
        if self._last_update is None:
            self._last_update = now_ms
        dt = min((now_ms - self._last_update) / 1000.0, 1.0)
        self._last_update = now_ms

        if state == "overuse":
            self._state = "decrease"
        elif state == "underuse":
            self._state = "hold"
        else:  # normal
            if self._state == "decrease":
                self._state = "hold"
            elif self._state == "hold":
                self._state = "increase"

        if self._state == "decrease":
            self.bitrate = int(ALPHA * incoming_bitrate) \
                if incoming_bitrate > 0 else int(ALPHA * self.bitrate)
            m = self._avg_max_bitrate
            self._avg_max_bitrate = incoming_bitrate if m is None \
                else 0.95 * m + 0.05 * incoming_bitrate
        elif self._state == "increase":
            near_max = (self._avg_max_bitrate is not None
                        and incoming_bitrate > 0.95 * self._avg_max_bitrate)
            if near_max:
                self.bitrate += int(max(1000, 0.08 * self.bitrate) * dt * 8)
            else:
                self.bitrate = int(self.bitrate * (ETA ** dt))
        self.bitrate = max(MIN_BITRATE, min(MAX_BITRATE, self.bitrate))
        return self.bitrate


class DelayBasedEstimator:
    """Packet feed → bitrate estimate (receiver- or TWCC-sender-side)."""

    def __init__(self, start_bitrate: int = 2_000_000):
        self.trendline = TrendlineEstimator()
        self.detector = OveruseDetector()
        self.controller = AimdRateController(start_bitrate)
        self._group: Optional[_Group] = None
        self._prev_group: Optional[_Group] = None
        self._n_deltas = 0
        self._recv_window: Deque[Tuple[float, int]] = deque()

    @property
    def bitrate(self) -> int:
        return self.controller.bitrate

    def incoming_bitrate(self, now_ms: float, window_ms: float = 500.0) -> float:
        while self._recv_window and self._recv_window[0][0] < now_ms - window_ms:
            self._recv_window.popleft()
        if not self._recv_window:
            return 0.0
        span = max(now_ms - self._recv_window[0][0], 1.0)
        return sum(s for _, s in self._recv_window) * 8000.0 / span

    def add_packet(self, send_ms: float, arrival_ms: float, size: int) -> int:
        """Feed one packet (send timestamp, arrival timestamp, bytes);
        returns the current bitrate estimate."""
        self._recv_window.append((arrival_ms, size))
        g = self._group
        if g is None:
            self._group = _Group(send_ms, send_ms, arrival_ms, arrival_ms, size)
            return self.controller.bitrate
        if send_ms - g.first_send_ms > BURST_INTERVAL_MS:
            # close the group, compare with previous
            if self._prev_group is not None:
                send_delta = g.last_send_ms - self._prev_group.last_send_ms
                recv_delta = g.last_arrival_ms - self._prev_group.last_arrival_ms
                self._n_deltas += 1
                trend = self.trendline.update(recv_delta, send_delta, arrival_ms)
                state = self.detector.update(trend, self._n_deltas, arrival_ms)
                self.controller.update(
                    state, self.incoming_bitrate(arrival_ms), arrival_ms)
            self._prev_group = g
            self._group = _Group(send_ms, send_ms, arrival_ms, arrival_ms, size)
        else:
            g.last_send_ms = max(g.last_send_ms, send_ms)
            g.last_arrival_ms = max(g.last_arrival_ms, arrival_ms)
            g.size += size
        return self.controller.bitrate


class LossBasedEstimator:
    """RFC-style loss controller: cut above 10% loss, grow below 2%."""

    def __init__(self, start_bitrate: int = 2_000_000):
        self.bitrate = start_bitrate

    def update(self, fraction_lost: float) -> int:
        if fraction_lost > 0.10:
            self.bitrate = int(self.bitrate * (1 - 0.5 * fraction_lost))
        elif fraction_lost < 0.02:
            self.bitrate = int(self.bitrate * 1.05 + 1000)
        self.bitrate = max(MIN_BITRATE, min(MAX_BITRATE, self.bitrate))
        return self.bitrate


class GccEstimator:
    """Combined estimator: min(delay-based, loss-based)."""

    def __init__(self, start_bitrate: int = 2_000_000):
        self.delay = DelayBasedEstimator(start_bitrate)
        self.loss = LossBasedEstimator(start_bitrate)

    @property
    def bitrate(self) -> int:
        return min(self.delay.bitrate, self.loss.bitrate)

    def add_packet(self, send_ms: float, arrival_ms: float, size: int) -> int:
        self.delay.add_packet(send_ms, arrival_ms, size)
        return self.bitrate

    def add_loss_report(self, fraction_lost: float) -> int:
        self.loss.update(fraction_lost)
        return self.bitrate

    def feed_remb(self, bitrate: int) -> int:
        """Receiver-estimated max bitrate caps the loss-based estimate
        (it recovers upward by the loss controller's clean-report growth)."""
        self.loss.bitrate = min(self.loss.bitrate,
                                max(MIN_BITRATE, int(bitrate)))
        return self.bitrate

    def feed_twcc(self, received: List[Tuple[int, Optional[int]]],
                  send_info: dict) -> int:
        """Sender-side estimation from a TWCC feedback packet: ``received``
        is RtcpTwcc.received; ``send_info`` maps twcc-seq → either a send
        time (ms) or a ``(send_ms, size_bytes)`` tuple — real sizes keep
        the AIMD decrease target honest."""
        lost = sum(1 for _, t in received if t is None)
        if received:
            self.loss.update(lost / len(received))
        for seq, t_us in received:
            if t_us is None:
                continue
            info = send_info.get(seq)
            if info is None:
                continue
            if isinstance(info, tuple):
                send_ms, size = info
            else:
                send_ms, size = info, 1200
            self.delay.add_packet(send_ms, t_us / 1000.0, size)
        return self.bitrate

"""Audio capture sources + the chunked Opus capture loop.

Capability-parity with pcmflux's ``AudioCapture.start_capture(settings,
callback)`` surface (reference selkies.py:1005-1026): a capture thread pulls
20 ms PCM chunks from a source, applies the silence gate, Opus-encodes, and
hands packets to a callback.  Sources: PulseAudio monitor (when libpulse is
present) or synthetic generators for tests/headless rigs.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np

from ..native import audio_lib
from .codec import OpusEncoder, pulse_available

logger = logging.getLogger("selkies_tpu_torch.audio")


@dataclass
class AudioCaptureSettings:
    """Mirrors the reference's pcmflux AudioCaptureSettings fields
    (selkies.py:1005-1015)."""

    device_name: str = ""
    sample_rate: int = 48000
    channels: int = 2
    opus_bitrate: int = 320000
    frame_duration_ms: int = 20
    use_vbr: bool = True
    use_silence_gate: bool = False
    debug_logging: bool = False

    @property
    def chunk_frames(self) -> int:
        return self.sample_rate * self.frame_duration_ms // 1000


class PcmSource:
    """A blocking PCM source delivering int16 interleaved chunks."""

    def read_chunk(self, frames: int) -> Optional[np.ndarray]:
        raise NotImplementedError

    def close(self) -> None:
        pass


class PulseSource(PcmSource):
    """PulseAudio record stream (typically a sink monitor)."""

    def __init__(self, settings: AudioCaptureSettings) -> None:
        lib = audio_lib()
        if lib is None or not lib.sa_pulse_available():
            raise RuntimeError("libpulse unavailable")
        self._lib = lib
        self.channels = settings.channels
        self._h = lib.sa_pa_new(settings.device_name.encode() or None,
                                settings.sample_rate, settings.channels, 0,
                                b"selkies-audio-capture")
        if not self._h:
            raise RuntimeError(
                f"pulse capture open failed (device={settings.device_name!r})")

    def read_chunk(self, frames: int) -> Optional[np.ndarray]:
        buf = np.empty(frames * self.channels, np.int16)
        rc = self._lib.sa_pa_read(self._h, buf, buf.nbytes)
        return buf if rc == 0 else None

    def close(self) -> None:
        if self._h:
            self._lib.sa_pa_free(self._h)
            self._h = None


class SyntheticTone(PcmSource):
    """Deterministic sine source, real-time paced (tests / headless)."""

    def __init__(self, settings: AudioCaptureSettings, freq: float = 440.0,
                 amplitude: float = 0.3, realtime: bool = True) -> None:
        self.rate = settings.sample_rate
        self.channels = settings.channels
        self.freq = freq
        self.amp = amplitude
        self.realtime = realtime
        self._t = 0

    def read_chunk(self, frames: int) -> Optional[np.ndarray]:
        if self.realtime:
            time.sleep(frames / self.rate)
        n = np.arange(self._t, self._t + frames)
        self._t += frames
        wave = np.sin(2 * np.pi * self.freq * n / self.rate) * self.amp
        pcm = (wave * 32767).astype(np.int16)
        return np.repeat(pcm, self.channels)


class SilenceSource(PcmSource):
    """All-zero source (exercises the silence gate)."""

    def __init__(self, settings: AudioCaptureSettings,
                 realtime: bool = True) -> None:
        self.rate = settings.sample_rate
        self.channels = settings.channels
        self.realtime = realtime

    def read_chunk(self, frames: int) -> Optional[np.ndarray]:
        if self.realtime:
            time.sleep(frames / self.rate)
        return np.zeros(frames * self.channels, np.int16)


def open_source(settings: AudioCaptureSettings) -> PcmSource:
    """Best available source: Pulse monitor, else a silent synthetic feed
    (keeps the pipeline alive on hosts with no audio server)."""
    if pulse_available():
        try:
            return PulseSource(settings)
        except RuntimeError as e:
            logger.warning("pulse capture unavailable (%s); using silence", e)
    return SilenceSource(settings)


# Reference pcmflux gates chunks whose peak stays under a small threshold;
# hangover keeps a few trailing chunks so decoders ring down naturally.
SILENCE_THRESHOLD = 192       # of 32767 peak
SILENCE_HANGOVER_CHUNKS = 25  # 500 ms at 20 ms chunks


class AudioCapture:
    """Capture thread: source → silence gate → Opus → callback(bytes).

    The callback runs on the capture thread; callers marshal into asyncio
    themselves (same contract as the reference's C callback,
    selkies.py:939-952).
    """

    def __init__(self, settings: AudioCaptureSettings,
                 callback: Callable[[bytes], None],
                 source: Optional[PcmSource] = None) -> None:
        self.settings = settings
        self.callback = callback
        self.source = source if source is not None else open_source(settings)
        self._enc: Optional[OpusEncoder] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.chunks_encoded = 0
        self.chunks_gated = 0

    def start_capture(self) -> None:
        if self._thread is not None:
            return
        self._enc = OpusEncoder(
            self.settings.sample_rate, self.settings.channels,
            self.settings.opus_bitrate, vbr=self.settings.use_vbr)
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="selkies-audio-capture", daemon=True)
        self._thread.start()

    def stop_capture(self) -> None:
        self._stop.set()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=2.0)
            if thread.is_alive():
                # The thread is wedged in a blocking source read; freeing the
                # encoder under it would be a use-after-free.  Leak both and
                # let the thread exit on its next wakeup (it checks _stop).
                logger.warning("capture thread did not stop in 2 s; "
                               "leaking encoder/source until it exits")
                return
        if self._enc is not None:
            self._enc.close()
            self._enc = None
        self.source.close()

    def _run(self) -> None:
        frames = self.settings.chunk_frames
        enc = self._enc  # local ref: survives stop_capture() racing us
        quiet_for = SILENCE_HANGOVER_CHUNKS  # start gated until sound appears
        while not self._stop.is_set():
            pcm = self.source.read_chunk(frames)
            if pcm is None:
                time.sleep(0.01)
                continue
            if self._stop.is_set():
                break
            if self.settings.use_silence_gate:
                peak = int(np.abs(pcm).max()) if pcm.size else 0
                quiet_for = 0 if peak >= SILENCE_THRESHOLD else quiet_for + 1
                if quiet_for > SILENCE_HANGOVER_CHUNKS:
                    self.chunks_gated += 1
                    continue
            try:
                packet = enc.encode(pcm)
            except RuntimeError as e:
                logger.error("opus encode failed: %s", e)
                continue
            self.chunks_encoded += 1
            self.callback(packet)

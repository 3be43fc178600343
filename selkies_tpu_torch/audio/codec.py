"""Opus codec over the native audio runtime (ctypes).

Python face of the pcmflux-equivalent encode stage (reference consumes
pcmflux's Opus output at selkies.py:939-952 and ships it as ``b'\\x01\\x00'``
frames).  Audio is CPU work by design (SURVEY.md §7).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..native import audio_lib


def opus_available() -> bool:
    lib = audio_lib()
    return bool(lib and lib.sa_opus_available())


def pulse_available() -> bool:
    lib = audio_lib()
    return bool(lib and lib.sa_pulse_available())


class OpusEncoder:
    """Streaming Opus encoder (s16 interleaved in, packets out)."""

    def __init__(self, sample_rate: int = 48000, channels: int = 2,
                 bitrate: int = 320000, vbr: bool = True,
                 complexity: int = 10, lowdelay: bool = False,
                 inband_fec: bool = False) -> None:
        lib = audio_lib()
        if lib is None or not lib.sa_opus_available():
            raise RuntimeError("libopus unavailable")
        self._lib = lib
        self._h = lib.sa_enc_new(sample_rate, channels, bitrate,
                                 int(vbr), complexity, int(lowdelay),
                                 int(inband_fec))
        if not self._h:
            raise RuntimeError("opus encoder init failed")
        self.sample_rate = sample_rate
        self.channels = channels
        self._out = np.empty(4000, np.uint8)  # opus recommended max packet

    def encode(self, pcm: np.ndarray) -> bytes:
        """``pcm``: int16 array of interleaved samples, shape (frames*ch,)
        or (frames, ch); frames must be a valid Opus frame size."""
        pcm = np.ascontiguousarray(pcm, np.int16).reshape(-1)
        frames = pcm.size // self.channels
        n = self._lib.sa_enc_encode(self._h, pcm, frames, self._out,
                                    self._out.size)
        if n < 0:
            raise RuntimeError(f"opus_encode error {n}")
        return bytes(self._out[:n])

    def close(self) -> None:
        if self._h:
            self._lib.sa_enc_free(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass


class OpusDecoder:
    """Streaming Opus decoder (packets in, s16 interleaved out)."""

    def __init__(self, sample_rate: int = 48000, channels: int = 2) -> None:
        lib = audio_lib()
        if lib is None or not lib.sa_opus_available():
            raise RuntimeError("libopus unavailable")
        self._lib = lib
        self._h = lib.sa_dec_new(sample_rate, channels)
        if not self._h:
            raise RuntimeError("opus decoder init failed")
        self.sample_rate = sample_rate
        self.channels = channels
        # 120 ms at 48 kHz is the max opus frame
        self._buf = np.empty(5760 * channels, np.int16)

    def decode(self, packet: bytes) -> np.ndarray:
        """→ int16 array (frames, channels)."""
        data = np.frombuffer(packet, np.uint8)
        n = self._lib.sa_dec_decode(
            self._h, np.ascontiguousarray(data), len(packet), self._buf,
            self._buf.size // self.channels)
        if n < 0:
            raise RuntimeError(f"opus_decode error {n}")
        return self._buf[:n * self.channels].reshape(n, self.channels).copy()

    def decode_fec(self, next_packet: bytes, frames: int) -> np.ndarray:
        """Reconstruct a LOST frame from the in-band FEC data of the
        packet that followed it. ``frames`` = the lost frame's duration
        in samples/channel (960 for the 20 ms default)."""
        frames = min(int(frames), self._buf.size // self.channels)
        data = np.frombuffer(next_packet, np.uint8)
        n = self._lib.sa_dec_decode_fec(
            self._h, np.ascontiguousarray(data), len(next_packet),
            self._buf, frames)
        if n < 0:
            raise RuntimeError(f"opus_decode fec error {n}")
        return self._buf[:n * self.channels].reshape(n, self.channels).copy()

    def decode_plc(self, frames: int) -> np.ndarray:
        """Packet-loss concealment when no FEC data is available."""
        frames = min(int(frames), self._buf.size // self.channels)
        n = self._lib.sa_dec_plc(self._h, self._buf, frames)
        if n < 0:
            raise RuntimeError(f"opus plc error {n}")
        return self._buf[:n * self.channels].reshape(n, self.channels).copy()

    def close(self) -> None:
        if self._h:
            self._lib.sa_dec_free(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass

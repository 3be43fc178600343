"""Server-side audio pipeline: capture→Opus broadcast + mic reverse path.

Equivalent of the reference's pcmflux pipeline (capture thread → asyncio
queue → ``b'\\x01\\x00'+opus`` broadcast, selkies.py:939-1090) and its mic
ingest (binary 0x02 PCM frames → PulseAudio virtual source playback,
selkies.py:1642-1844).  Plugs into ``DataStreamingServer.audio_pipeline``
(START_AUDIO/STOP_AUDIO verbs and the 0x02 binary branch).
"""

from __future__ import annotations

import asyncio
import logging
from typing import Optional

import numpy as np

from ..native import audio_lib
from ..protocol.wire import pack_audio_chunk
from .capture import AudioCapture, AudioCaptureSettings, PcmSource
from .codec import pulse_available

logger = logging.getLogger("selkies_tpu_torch.audio")

_QUEUE_MAX = 64  # ~1.3 s of 20 ms chunks; drop-oldest beyond


class MicSink:
    """Destination for client microphone PCM (s16le interleaved).

    With PulseAudio present this plays into the virtual-source playback
    stream (the "SelkiesVirtualMic" role in the reference); headless hosts
    just count frames so the protocol path stays exercised.
    """

    def __init__(self, sample_rate: int = 48000, channels: int = 1) -> None:
        self.sample_rate = sample_rate
        self.channels = channels
        self.frames_in = 0
        self._h = None
        lib = audio_lib()
        if lib is not None and lib.sa_pulse_available():
            self._lib = lib
            self._h = lib.sa_pa_new(None, sample_rate, channels, 1,
                                    b"selkies-virtual-mic")
            if not self._h:
                logger.warning("mic playback stream open failed")

    def write(self, pcm_bytes: bytes) -> None:
        self.frames_in += 1
        if self._h:
            if len(pcm_bytes) % 2:  # truncated s16 frame: drop the odd byte
                pcm_bytes = pcm_bytes[:-1]
            if not pcm_bytes:
                return
            pcm = np.frombuffer(pcm_bytes, np.int16)
            self._lib.sa_pa_write(self._h, np.ascontiguousarray(pcm),
                                  pcm.nbytes)

    def close(self) -> None:
        if self._h:
            self._lib.sa_pa_free(self._h)
            self._h = None


class AudioPipeline:
    """Owns the capture thread, the chunk queue, and the sender task."""

    def __init__(self, server, settings: AudioCaptureSettings,
                 source: Optional[PcmSource] = None) -> None:
        self.server = server
        self.settings = settings
        self._source = source
        self._capture: Optional[AudioCapture] = None
        self._queue: Optional[asyncio.Queue] = None
        self._sender: Optional[asyncio.Task] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self.mic = MicSink(sample_rate=settings.sample_rate, channels=1)
        self.chunks_sent = 0
        self.chunks_dropped = 0

    @property
    def running(self) -> bool:
        return self._capture is not None

    # -- capture-thread side -------------------------------------------------

    def _on_chunk(self, packet: bytes) -> None:
        loop, queue = self._loop, self._queue
        if loop is None or queue is None or loop.is_closed():
            return
        loop.call_soon_threadsafe(self._enqueue, queue, packet)

    def _enqueue(self, queue: asyncio.Queue, packet: bytes) -> None:
        if queue.full():  # audio is realtime: drop oldest, keep newest
            try:
                queue.get_nowait()
                self.chunks_dropped += 1
            except asyncio.QueueEmpty:
                pass
        queue.put_nowait(packet)

    # -- asyncio side --------------------------------------------------------

    async def start(self) -> None:
        if self.running:
            return
        self._loop = asyncio.get_running_loop()
        self._queue = asyncio.Queue(_QUEUE_MAX)

        def _build():  # source open (pa_simple_new) blocks: off the loop
            cap = AudioCapture(self.settings, self._on_chunk,
                               source=self._source)
            cap.start_capture()
            return cap

        self._capture = await asyncio.to_thread(_build)
        self._sender = asyncio.create_task(self._send_loop())
        logger.info("audio pipeline started (%d Hz, %d ch, %d bps, pulse=%s)",
                    self.settings.sample_rate, self.settings.channels,
                    self.settings.opus_bitrate, pulse_available())

    async def stop(self) -> None:
        cap, self._capture = self._capture, None
        if cap is not None:
            await asyncio.to_thread(cap.stop_capture)
        if self._sender is not None:
            self._sender.cancel()
            try:
                await self._sender
            except asyncio.CancelledError:
                pass
            self._sender = None
        self._queue = None

    async def _send_loop(self) -> None:
        queue = self._queue
        while True:
            packet = await queue.get()
            self.server.broadcast(pack_audio_chunk(packet))
            self.chunks_sent += 1

    async def on_mic_data(self, pcm: bytes) -> None:
        """Binary 0x02 payload from the client's mic worklet."""
        await asyncio.to_thread(self.mic.write, pcm)

    def close(self) -> None:
        self.mic.close()

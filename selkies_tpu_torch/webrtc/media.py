"""Media plumbing: MediaPlayer / MediaRecorder / MediaRelay / MediaBlackhole.

Role parity with the reference's vendored contrib/media.py
(the reference's ``src/selkies/webrtc/contrib/media.py:87-300``), re-scoped
to this framework's formats instead of PyAV: the compute path produces
Annex-B H.264 (the encoder's), JPEG stripes, and Opus/PCM audio, so the file
plumbing speaks exactly those containers —

  MediaPlayer    .wav (PCM s16) → 20 ms audio frames (Opus-encoded when
                 libopus is loaded, raw PCM otherwise)
                 .h264/.264 (Annex-B) → access units at a fixed fps
                 .y4m (YUV4MPEG2 420) → raw frames for encoder pipelines
  MediaRecorder  .wav ← audio frames (Opus decoded back to PCM when
                 possible), .h264 ← Annex-B AUs, .mjpeg ← JPEG frames
  MediaRelay     one source track fanned out to N subscriber tracks
  MediaBlackhole consume-and-discard sink (keeps senders pumping)

Tracks are tiny async objects: ``await track.recv()`` yields
``(payload: bytes, timestamp_ms: int)`` and raises ``MediaStreamError``
at end of stream — the contract `stream_to()` uses to pump a
``MediaSender``.
"""

from __future__ import annotations

import asyncio
import os
import struct
import time
from typing import Dict, List, Optional, Tuple

__all__ = [
    "MediaStreamError", "MediaTrack", "MediaBlackhole", "MediaPlayer",
    "MediaRecorder", "MediaRelay", "stream_to",
]


class MediaStreamError(Exception):
    """End of stream (or track stopped)."""


class MediaTrack:
    kind = "video"

    async def recv(self) -> Tuple[bytes, int]:
        raise NotImplementedError

    def stop(self) -> None:
        pass


# ---------------------------------------------------------------- sources


def _split_access_units(data: bytes) -> List[bytes]:
    """Split an Annex-B elementary stream into access units.

    A new AU starts at an AUD NAL (type 9) or at a VCL NAL whose
    first_mb_in_slice == 0 — the first ue(v) of the slice header, which
    is zero exactly when the first payload bit after the NAL header is 1.
    Multi-slice pictures (e.g. .h264 files recorded from this framework's
    own multi-stripe frames, one slice NAL per stripe) therefore keep all
    their slices in one AU and replay at the real frame rate. Stripe
    recordings replay as full-frame AUs: per-stripe geometry is not
    representable in an elementary stream. Leading SPS/PPS/SEI attach to
    the AU that follows them."""
    starts: List[int] = []
    i = 0
    n = len(data)
    while i < n - 3:
        if data[i:i + 3] == b"\x00\x00\x01":
            starts.append(i)
            i += 3
        elif data[i:i + 4] == b"\x00\x00\x00\x01":
            starts.append(i)
            i += 4
        else:
            i += 1
    if not starts:
        return [data] if data else []
    units: List[Tuple[int, int, int]] = []   # (nal_type, offset, payload_off)
    for off in starts:
        j = off + (4 if data[off:off + 4] == b"\x00\x00\x00\x01" else 3)
        if j < n:
            units.append((data[j] & 0x1F, off, j + 1))
    if not units:
        return [data]
    new_au = []
    for nal, off, poff in units:
        first_slice = (nal in (1, 5) and poff < n
                       and (data[poff] & 0x80) != 0)
        new_au.append(nal == 9 or first_slice)
    bounds: List[int] = [0]              # indices into units starting an AU
    seen_vcl = False
    for idx, (nal, off, poff) in enumerate(units):
        if idx > 0 and new_au[idx] and seen_vcl:
            # pull the contiguous non-VCL run before this NAL into the
            # new AU — those parameter sets/SEI prefix the coming picture
            j = idx
            while j - 1 > bounds[-1] and units[j - 1][0] not in (1, 5):
                j -= 1
            bounds.append(j)
            seen_vcl = False
        if nal in (1, 5):
            seen_vcl = True
    aus: List[bytes] = []
    for bi, ui in enumerate(bounds):
        start = units[ui][1]
        end = units[bounds[bi + 1]][1] if bi + 1 < len(bounds) else n
        aus.append(data[start:end])
    return aus


class _AudioFileTrack(MediaTrack):
    kind = "audio"

    def __init__(self, pcm: "memoryview", sample_rate: int, channels: int,
                 frame_ms: int = 20, loop: bool = False,
                 encode_opus: bool = True):
        import numpy as np
        self._np = np
        self._pcm = np.frombuffer(pcm, dtype=np.int16).reshape(-1, channels)
        self.sample_rate = sample_rate
        self.channels = channels
        self.samples_per_frame = sample_rate * frame_ms // 1000
        self._pos = 0
        self._loop = loop
        self._t0: Optional[float] = None
        self._frames = 0
        self._enc = None
        if encode_opus:
            try:
                from ..audio.codec import OpusEncoder
                self._enc = OpusEncoder(sample_rate, channels)
            except Exception:
                self._enc = None    # raw PCM frames (tests / no libopus)

    @property
    def encodes_opus(self) -> bool:
        return self._enc is not None

    async def recv(self) -> Tuple[bytes, int]:
        spf = self.samples_per_frame
        if self._pos + spf > len(self._pcm):
            if not self._loop or not len(self._pcm):
                raise MediaStreamError("end of audio")
            self._pos = 0
        chunk = self._pcm[self._pos:self._pos + spf]
        self._pos += spf
        # real-time pacing so a live PeerConnection isn't flooded
        if self._t0 is None:
            self._t0 = time.monotonic()
        due = self._t0 + self._frames * spf / self.sample_rate
        delay = due - time.monotonic()
        if delay > 0:
            await asyncio.sleep(delay)
        self._frames += 1
        ts = (self._frames - 1) * spf
        if self._enc is not None:
            return self._enc.encode(self._np.ascontiguousarray(chunk)), ts
        return chunk.tobytes(), ts


class _VideoFileTrack(MediaTrack):
    kind = "video"

    def __init__(self, aus: List[bytes], fps: float, loop: bool = False):
        self._aus = aus
        self._fps = fps
        self._i = 0
        self._loop = loop
        self._t0: Optional[float] = None
        self._sent = 0

    async def recv(self) -> Tuple[bytes, int]:
        if self._i >= len(self._aus):
            if not self._loop or not self._aus:
                raise MediaStreamError("end of video")
            self._i = 0
        au = self._aus[self._i]
        self._i += 1
        if self._t0 is None:
            self._t0 = time.monotonic()
        due = self._t0 + self._sent / self._fps
        delay = due - time.monotonic()
        if delay > 0:
            await asyncio.sleep(delay)
        ts = int(self._sent * 90000 / self._fps)   # RTP video clock
        self._sent += 1
        return au, ts


class _Y4mFileTrack(MediaTrack):
    """Raw YUV4MPEG2 4:2:0 frames as (H, W, 3)-shaped RGB-like planes are
    NOT reconstructed here — frames are yielded as the raw planar YUV
    bytes plus timestamp; encoder pipelines own the colorspace."""

    kind = "video"

    def __init__(self, path: str, loop: bool = False):
        self._f = open(path, "rb")
        header = self._f.readline().decode("ascii", "replace")
        if not header.startswith("YUV4MPEG2"):
            raise ValueError("not a y4m file")
        self.width = self.height = 0
        num, den = 30, 1
        for tok in header.split()[1:]:
            if tok[0] == "W":
                self.width = int(tok[1:])
            elif tok[0] == "H":
                self.height = int(tok[1:])
            elif tok[0] == "F":
                num, den = (int(x) for x in tok[1:].split(":"))
        self.fps = num / max(1, den)
        self._frame_bytes = self.width * self.height * 3 // 2
        self._loop = loop
        self._start = self._f.tell()
        self._n = 0
        self._t0: Optional[float] = None

    async def recv(self) -> Tuple[bytes, int]:
        line = self._f.readline()
        if not line.startswith(b"FRAME"):
            if self._loop and line == b"":
                self._f.seek(self._start)
                line = self._f.readline()
            if not line.startswith(b"FRAME"):
                raise MediaStreamError("end of y4m")
        data = self._f.read(self._frame_bytes)
        if len(data) < self._frame_bytes:
            raise MediaStreamError("truncated y4m frame")
        if self._t0 is None:
            self._t0 = time.monotonic()
        due = self._t0 + self._n / self.fps
        delay = due - time.monotonic()
        if delay > 0:
            await asyncio.sleep(delay)
        ts = int(self._n * 90000 / self.fps)
        self._n += 1
        return data, ts

    def stop(self) -> None:
        self._f.close()


def _parse_wav(path: str) -> Tuple[bytes, int, int]:
    """(pcm_s16_bytes, sample_rate, channels) from a RIFF WAVE file."""
    with open(path, "rb") as f:
        riff = f.read(12)
        if riff[:4] != b"RIFF" or riff[8:12] != b"WAVE":
            raise ValueError("not a wav file")
        rate = channels = 0
        data = b""
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                break
            cid, size = hdr[:4], struct.unpack("<I", hdr[4:])[0]
            body = f.read(size)
            if cid == b"fmt ":
                fmt, channels, rate = struct.unpack_from("<HHI", body)
                bits = struct.unpack_from("<H", body, 14)[0]
                if fmt != 1 or bits != 16:
                    raise ValueError("only PCM s16 wav supported")
            elif cid == b"data":
                data = body
            if size % 2:
                f.read(1)
        if not rate or not channels:
            raise ValueError("wav missing fmt chunk")
        return data, rate, channels


class MediaPlayer:
    """File → tracks. ``player.audio`` / ``player.video`` expose whichever
    track the file provides (None otherwise)."""

    def __init__(self, path: str, loop: bool = False, fps: float = 30.0,
                 encode_opus: bool = True):
        self.audio: Optional[MediaTrack] = None
        self.video: Optional[MediaTrack] = None
        ext = os.path.splitext(path)[1].lower()
        if ext == ".wav":
            pcm, rate, ch = _parse_wav(path)
            self.audio = _AudioFileTrack(memoryview(pcm), rate, ch,
                                         loop=loop, encode_opus=encode_opus)
        elif ext in (".h264", ".264", ".annexb"):
            with open(path, "rb") as f:
                aus = _split_access_units(f.read())
            self.video = _VideoFileTrack(aus, fps, loop=loop)
        elif ext == ".y4m":
            self.video = _Y4mFileTrack(path, loop=loop)
        else:
            raise ValueError(f"unsupported media container: {ext!r}")

    def stop(self) -> None:
        for t in (self.audio, self.video):
            if t is not None:
                t.stop()


# ------------------------------------------------------------------ sinks


class MediaBlackhole:
    """Consume tracks and discard frames (keeps upstream pumps draining)."""

    def __init__(self) -> None:
        self._tracks: List[MediaTrack] = []
        self._tasks: List[asyncio.Task] = []
        self.consumed = 0

    def addTrack(self, track: MediaTrack) -> None:
        self._tracks.append(track)

    async def start(self) -> None:
        for t in self._tracks:
            self._tasks.append(asyncio.ensure_future(self._drain(t)))

    async def _drain(self, track: MediaTrack) -> None:
        while True:
            try:
                await track.recv()
            except MediaStreamError:
                return
            self.consumed += 1

    async def stop(self) -> None:
        for task in self._tasks:
            task.cancel()
        self._tasks = []


class MediaRecorder:
    """Tracks → file. Container from the extension: .wav / .h264 / .mjpeg."""

    def __init__(self, path: str, sample_rate: int = 48000,
                 channels: int = 2):
        self.path = path
        self.sample_rate = sample_rate
        self.channels = channels
        self._ext = os.path.splitext(path)[1].lower()
        if self._ext not in (".wav", ".h264", ".264", ".mjpeg", ".mjpg"):
            raise ValueError(f"unsupported recorder container: {self._ext!r}")
        self._tracks: List[MediaTrack] = []
        self._tasks: List[asyncio.Task] = []
        self._f = None
        self._pcm_bytes = 0
        self._dec = None

    def addTrack(self, track: MediaTrack) -> None:
        self._tracks.append(track)

    async def start(self) -> None:
        self._f = open(self.path, "wb")
        if self._ext == ".wav":
            self._f.write(b"\x00" * 44)         # header backpatched on stop
            try:
                from ..audio.codec import OpusDecoder
                self._dec = OpusDecoder(self.sample_rate, self.channels)
            except Exception:
                self._dec = None
        for t in self._tracks:
            self._tasks.append(asyncio.ensure_future(self._pump(t)))

    async def _pump(self, track: MediaTrack) -> None:
        while True:
            try:
                payload, _ts = await track.recv()
            except MediaStreamError:
                return
            if self._f is None:
                return
            if self._ext == ".wav":
                data = payload
                if self._dec is not None:
                    try:
                        data = self._dec.decode(payload).tobytes()
                    except Exception:
                        pass            # raw PCM track — write as-is
                self._f.write(data)
                self._pcm_bytes += len(data)
            else:
                self._f.write(payload)

    async def stop(self) -> None:
        for task in self._tasks:
            task.cancel()
            try:
                await task
            except (asyncio.CancelledError, Exception):
                pass
        self._tasks = []
        if self._f is None:
            return
        if self._ext == ".wav":
            sr, ch, nbytes = self.sample_rate, self.channels, self._pcm_bytes
            self._f.seek(0)
            self._f.write(
                b"RIFF" + struct.pack("<I", 36 + nbytes) + b"WAVE"
                + b"fmt " + struct.pack("<IHHIIHH", 16, 1, ch, sr,
                                        sr * ch * 2, ch * 2, 16)
                + b"data" + struct.pack("<I", nbytes))
        self._f.close()
        self._f = None


# ------------------------------------------------------------------ relay


class _RelayTrack(MediaTrack):
    def __init__(self, kind: str, buffered: bool):
        self.kind = kind
        self._q: asyncio.Queue = asyncio.Queue() if buffered \
            else asyncio.Queue(maxsize=1)
        self._stopped = False
        self._ended = False

    async def recv(self) -> Tuple[bytes, int]:
        if self._stopped:
            raise MediaStreamError("relay stopped")
        if self._ended and self._q.empty():
            raise MediaStreamError("source ended")
        item = await self._q.get()
        if item is None:
            raise MediaStreamError("source ended")
        return item

    def _push(self, item) -> None:
        if self._stopped:
            return
        if self._q.maxsize == 1 and self._q.full():
            try:                         # live mode: newest frame wins
                self._q.get_nowait()
            except asyncio.QueueEmpty:
                pass
        self._q.put_nowait(item)

    def _finish(self) -> None:
        """End of source: never displace a pending frame — wake blocked
        consumers with the sentinel only when the queue is empty."""
        self._ended = True
        if self._q.empty():
            self._q.put_nowait(None)

    def stop(self) -> None:
        self._stopped = True


class MediaRelay:
    """Fan one source track out to many subscribers. ``buffered=False``
    (live) drops stale frames for slow consumers; ``buffered=True``
    queues everything (recording)."""

    def __init__(self) -> None:
        self._pumps: Dict[int, asyncio.Task] = {}
        self._subs: Dict[int, List[_RelayTrack]] = {}

    def subscribe(self, track: MediaTrack,
                  buffered: bool = True) -> MediaTrack:
        key = id(track)
        out = _RelayTrack(track.kind, buffered)
        self._subs.setdefault(key, []).append(out)
        if key not in self._pumps:
            self._pumps[key] = asyncio.ensure_future(self._pump(key, track))
        return out

    async def _pump(self, key: int, track: MediaTrack) -> None:
        while True:
            try:
                item = await track.recv()
            except MediaStreamError:
                for sub in self._subs.get(key, []):
                    sub._finish()
                return
            for sub in self._subs.get(key, []):
                sub._push(item)

    def stop(self) -> None:
        for task in self._pumps.values():
            task.cancel()
        self._pumps.clear()
        for subs in self._subs.values():
            for s in subs:
                s.stop()
        self._subs.clear()


# ------------------------------------------------------------------ pump


async def stream_to(sender, track: MediaTrack) -> int:
    """Pump a track into a MediaSender until end of stream; returns the
    number of frames shipped."""
    n = 0
    while True:
        try:
            payload, ts = await track.recv()
        except MediaStreamError:
            return n
        sender.send_frame(payload, timestamp=ts)
        n += 1

"""Byte-exact wire protocol codec (copy of ``selkies_tpu/protocol/wire.py``).

This module is the compatibility contract with the Selkies web client: the
binary layouts here are exactly what ``selkies-core.js`` demuxes in its
``websocket.onmessage`` switch (reference ``addons/gst-web-core/selkies-core.js``
lines 2753-2990) and the text verbs are what both sides exchange around it.
Keeping these byte-identical lets the reference client be used as an oracle
against this server.

Binary frames, server → client (first byte = type):

  0x00  full-frame H.264   [0x00][flags: 1=key][frame_id u16be][annexb...]
  0x01  audio              [0x01][0x00][opus packet...]
  0x03  JPEG stripe        [0x03][0x00][frame_id u16be][y_start u16be][jfif...]
  0x04  H.264 stripe       [0x04][flags: 1=key][frame_id u16be][y_start u16be]
                           [width u16be][height u16be][annexb...]

Binary frames, client → server:

  0x01  file upload chunk  [0x01][file bytes...]
  0x02  microphone PCM     [0x02][s16le PCM...]

Frame IDs are unsigned 16-bit with wraparound; see :class:`FrameId`.
"""

from __future__ import annotations

import enum
import json
import struct
from dataclasses import dataclass
from typing import Dict, Optional, Tuple, Union


class BinaryType(enum.IntEnum):
    """Server → client binary frame types (first byte)."""

    H264_FULL_FRAME = 0x00
    AUDIO_OPUS = 0x01
    JPEG_STRIPE = 0x03
    H264_STRIPE = 0x04


class ClientBinaryType(enum.IntEnum):
    """Client → server binary frame types; 0x01 here is a FILE chunk with a
    1-byte header (selkies-core.js:4030), not audio — direction matters."""

    FILE_CHUNK = 0x01
    MIC_PCM = 0x02


_U16 = struct.Struct(">H")


class ProtocolError(ValueError):
    """A frame that violates the client→server wire contract.

    Subclasses :class:`ValueError` so pre-existing callers that catch
    ``ValueError`` keep working; the server's per-message exception
    boundary counts these against the connection's error budget.
    """


# --------------------------------------------------------------------------
# Frame-id arithmetic (u16 wraparound)


class FrameId:
    """Unsigned-16-bit frame-id arithmetic with wraparound.

    The backpressure protocol computes ``sent - acked`` desync in modular
    arithmetic (reference selkies.py:1203-1214); a desync above
    ``WINDOW`` is treated as an anomalous wrap and reset.
    """

    MOD = 1 << 16
    WINDOW = 1 << 15

    @staticmethod
    def next(fid: int) -> int:
        return (fid + 1) % FrameId.MOD

    @staticmethod
    def desync(sent: int, acked: int) -> int:
        """How far `acked` lags `sent`, modulo 2**16; negative is clamped to
        the modular interpretation."""
        return (sent - acked) % FrameId.MOD

    @staticmethod
    def is_anomalous(sent: int, acked: int) -> bool:
        return FrameId.desync(sent, acked) >= FrameId.WINDOW


# --------------------------------------------------------------------------
# Typed frames


@dataclass(frozen=True)
class VideoStripe:
    frame_id: int
    y_start: int
    payload: bytes
    is_key: bool = True
    width: int = 0   # H.264 stripes only
    height: int = 0  # H.264 stripes only


@dataclass(frozen=True)
class FullFrame:
    frame_id: int
    payload: bytes
    is_key: bool


@dataclass(frozen=True)
class AudioChunk:
    payload: bytes


@dataclass(frozen=True)
class FileChunk:
    payload: bytes


@dataclass(frozen=True)
class MicChunk:
    payload: bytes


# --------------------------------------------------------------------------
# Packers


def pack_jpeg_stripe(frame_id: int, y_start: int, jpeg: bytes) -> bytes:
    """[0x03][0x00][frame_id][y_start][jfif] — client reads frame_id at
    offset 2 and y_start at offset 4 (selkies-core.js:2908-2915)."""
    return (
        bytes((BinaryType.JPEG_STRIPE, 0))
        + _U16.pack(frame_id & 0xFFFF)
        + _U16.pack(y_start & 0xFFFF)
        + jpeg
    )


def pack_h264_stripe(
    frame_id: int, y_start: int, width: int, height: int, annexb: bytes,
    is_key: bool,
) -> bytes:
    """10-byte header demuxed at selkies-core.js:2925-2945."""
    return (
        bytes((BinaryType.H264_STRIPE, 0x01 if is_key else 0x00))
        + _U16.pack(frame_id & 0xFFFF)
        + _U16.pack(y_start & 0xFFFF)
        + _U16.pack(width & 0xFFFF)
        + _U16.pack(height & 0xFFFF)
        + annexb
    )


def pack_full_frame(frame_id: int, annexb: bytes, is_key: bool) -> bytes:
    """[0x00][flags][frame_id][payload] (selkies-core.js:2814-2822)."""
    return (
        bytes((BinaryType.H264_FULL_FRAME, 0x01 if is_key else 0x00))
        + _U16.pack(frame_id & 0xFFFF)
        + annexb
    )


def pack_system_health(displays: Dict[str, Dict],
                       mesh: Dict[str, Dict] = None) -> str:
    """The ``system,health`` feed: per-display supervision state pushed to
    clients so degraded sessions are visible, not silent.

    ``displays`` maps display_id to a dict with at least ``rung`` (current
    degradation-ladder rung),
    ``supervisor`` (lifecycle state), and the restart counters. ``mesh``
    (optional) maps geometry-bucket keys to the session scheduler's
    lane/slot health snapshot (docs/scaling.md) — per-slot errors,
    quarantines, and migrations, so a sick fault domain is visible from
    the client overlay, not only from ``stats()``. Rides the same JSON
    channel as the stats feed; clients switch on ``type``.
    """
    payload = {
        "type": "system_health",
        "subsystem": "system,health",
        "displays": displays,
    }
    if mesh:
        payload["mesh"] = mesh
    return json.dumps(payload)


def pack_audio_chunk(opus: bytes) -> bytes:
    """[0x01][0x00][opus] (selkies-core.js:2874-2880, server selkies.py:976)."""
    return bytes((BinaryType.AUDIO_OPUS, 0)) + opus


def pack_mic_chunk(pcm_s16le: bytes) -> bytes:
    return bytes((ClientBinaryType.MIC_PCM,)) + pcm_s16le


def pack_file_chunk(chunk: bytes) -> bytes:
    return bytes((ClientBinaryType.FILE_CHUNK,)) + chunk


# --------------------------------------------------------------------------
# Unpacker (used by tests and by any Python client / conformance harness)


def unpack_client_binary(data: bytes) -> Union[FileChunk, MicChunk]:
    """Demux a client → server binary frame (1-byte header).

    This is a trust boundary: a server→client type byte (0x00/0x03/0x04)
    arriving *from* a client is a wrong-direction frame and raises
    :class:`ProtocolError`, same as any unknown type.
    """
    if not data:
        raise ProtocolError("empty binary frame")
    t = data[0]
    if t == ClientBinaryType.FILE_CHUNK:
        return FileChunk(payload=bytes(data[1:]))
    if t == ClientBinaryType.MIC_PCM:
        return MicChunk(payload=bytes(data[1:]))
    if t in BinaryType._value2member_map_:
        raise ProtocolError(
            f"server->client type byte 0x{t:02x} in a client frame")
    raise ProtocolError(f"unknown client binary type 0x{t:02x}")


def unpack_binary(
    data: bytes,
) -> Union[VideoStripe, FullFrame, AudioChunk, Tuple[BinaryType, bytes]]:
    """Demux a server → client binary frame (for client→server frames use
    :func:`unpack_client_binary` — type byte 0x01 means different things per
    direction)."""
    if not data:
        raise ValueError("empty binary frame")
    t = data[0]
    if t == BinaryType.H264_FULL_FRAME:
        if len(data) < 4:
            raise ValueError("short 0x00 frame")
        return FullFrame(
            frame_id=_U16.unpack_from(data, 2)[0],
            payload=bytes(data[4:]),
            is_key=data[1] == 1,
        )
    if t == BinaryType.AUDIO_OPUS:
        if len(data) < 2:
            raise ValueError("short 0x01 frame")
        return AudioChunk(payload=bytes(data[2:]))
    if t == BinaryType.JPEG_STRIPE:
        if len(data) < 6:
            raise ValueError("short 0x03 frame")
        return VideoStripe(
            frame_id=_U16.unpack_from(data, 2)[0],
            y_start=_U16.unpack_from(data, 4)[0],
            payload=bytes(data[6:]),
            is_key=True,
        )
    if t == BinaryType.H264_STRIPE:
        if len(data) < 10:
            raise ValueError("short 0x04 frame")
        return VideoStripe(
            frame_id=_U16.unpack_from(data, 2)[0],
            y_start=_U16.unpack_from(data, 4)[0],
            width=_U16.unpack_from(data, 6)[0],
            height=_U16.unpack_from(data, 8)[0],
            payload=bytes(data[10:]),
            is_key=data[1] == 0x01,
        )
    return (BinaryType(t) if t in BinaryType._value2member_map_ else t, bytes(data[1:]))


# --------------------------------------------------------------------------
# Text-message grammar
#
# Client → server verbs (reference ws_handler dispatch, selkies.py:1843-2300,
# and client sends in selkies-core.js / lib/input.js):
#
#   SETTINGS,{json}            settings negotiation
#   CLIENT_FRAME_ACK <id>      backpressure ack
#   r,<W>x<H>,<display_id>     resize request
#   s,<scale>                  scale request
#   cmd,<command>              command execution
#   SET_NATIVE_CURSOR_RENDERING,<0|1>
#   START_VIDEO / STOP_VIDEO / START_AUDIO / STOP_AUDIO
#   FILE_UPLOAD_START:<path>:<size> / FILE_UPLOAD_END:<path> /
#   FILE_UPLOAD_ERROR:<path>:<msg>
#   cr                         clipboard read request
#   cw,<b64> | cb,<mime>,<b64> clipboard write (text | binary)
#   cws,<size> cwd,<b64> cwe   chunked text clipboard
#   cbs,<mime>,<size> cbd,<b64> cbe  chunked binary clipboard
#   kd,<keysym> ku,<keysym>    key down/up
#   kr                         keyboard reset (all keys up)
#   m,... m2,...               mouse (abs , rel)
#   js,c/b/a/d,...             gamepad connect/button/axis/disconnect
#   _f <fps> / _l <latency>    client-reported metrics
#
# Server → client verbs:
#
#   MODE websockets
#   {json} with "type": server_settings | system_stats | gpu_stats |
#          network_stats | stream_resolution | display_config_update |
#          system_health (supervision/degradation state, "system,health"
#          feed — pack_system_health below)
#   cursor,{json}
#   clipboard,<b64> | clipboard_binary,<mime>,<b64>
#   clipboard_start,<mime>,<size> clipboard_data,<b64> clipboard_finish
#   PIPELINE_RESETTING <display_id>
#   KILL <reason>
#   VIDEO_STARTED / VIDEO_STOPPED / AUDIO_STARTED / AUDIO_STOPPED
#   system_stats etc. as JSON


@dataclass(frozen=True)
class TextMessage:
    """A parsed client→server text message."""

    verb: str
    args: Tuple[str, ...] = ()
    json_body: Optional[str] = None


_SIMPLE_VERBS = frozenset(
    {
        "START_VIDEO", "STOP_VIDEO", "START_AUDIO", "STOP_AUDIO",
        "cr", "cwe", "cbe", "kr",
    }
)

_COLON_VERBS = ("FILE_UPLOAD_START", "FILE_UPLOAD_END", "FILE_UPLOAD_ERROR")

#: server → client verbs that must never be accepted *from* a client: the
#: parser is a trust boundary, and before the exact-delimiter tightening
#: these fell through toward the input handler when spoofed by a client
_SERVER_ONLY_VERBS = frozenset({
    "KILL", "PIPELINE_RESETTING", "MODE",
    "VIDEO_STARTED", "VIDEO_STOPPED", "AUDIO_STARTED", "AUDIO_STOPPED",
})


def _is_verb(message: str, verb: str, delims: str = " ,") -> bool:
    """Exact verb-plus-delimiter match: ``verb`` alone, or ``verb``
    immediately followed by one of ``delims`` — never a prefix match, so
    ``CLIENT_FRAME_ACKjunk`` is NOT ``CLIENT_FRAME_ACK``."""
    if message == verb:
        return True
    return (message.startswith(verb)
            and len(message) > len(verb)
            and message[len(verb)] in delims)


def parse_text_message(message: str) -> TextMessage:
    """Parse a client→server text message into (verb, args).

    The grammar is positional and comma/space/colon-delimited depending on the
    verb family; this mirrors how the reference server branches on prefixes
    (selkies.py:1843-2300) but centralizes it in one typed parser.

    Trust-boundary rules (this parses *hostile* input):

    * verbs match exactly up to their delimiter — ``CLIENT_FRAME_ACKjunk``
      is an unknown verb, not an ACK;
    * server→client verbs (``KILL``, ``PIPELINE_RESETTING``, ``MODE``,
      ``VIDEO_STARTED``/…) raise :class:`ProtocolError` instead of falling
      through toward the input handler.
    """
    for verb in _SERVER_ONLY_VERBS:
        if _is_verb(message, verb):
            raise ProtocolError(
                f"server->client verb {verb!r} received from a client")
    if message in _SIMPLE_VERBS:
        return TextMessage(message)
    if message.startswith("SETTINGS,"):
        return TextMessage("SETTINGS", json_body=message[len("SETTINGS,"):])
    if _is_verb(message, "CLIENT_FRAME_ACK", " "):
        parts = message.split()
        return TextMessage("CLIENT_FRAME_ACK", tuple(parts[1:2]))
    for verb in _COLON_VERBS:
        if message.startswith(verb + ":"):
            rest = message[len(verb) + 1:]
            if verb == "FILE_UPLOAD_START":
                path, _, size = rest.rpartition(":")
                return TextMessage(verb, (path, size))
            if verb == "FILE_UPLOAD_ERROR":
                path, _, msg = rest.partition(":")
                return TextMessage(verb, (path, msg))
            return TextMessage(verb, (rest,))
    if _is_verb(message, "_f", " ") or _is_verb(message, "_l", " "):
        verb, _, val = message.partition(" ")
        return TextMessage(verb, (val,))
    if message.startswith("cmd,"):
        # the whole remainder is one free-text command; commas are content
        return TextMessage("cmd", (message[4:],))
    if "," in message:
        verb, _, rest = message.partition(",")
        return TextMessage(verb, tuple(rest.split(",")) if rest else ())
    return TextMessage(message)

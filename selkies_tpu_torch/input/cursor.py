"""Cursor-shape monitoring (XFixes) → client ``cursor,{json}`` payloads.

Parity with the reference cursor monitor (input_handler.py:1407-1505):
watch XFixesDisplayCursorNotify, fetch the ARGB cursor image, crop to its
alpha bounding box, cap oversized cursors, and ship
``{curdata: <b64 png>, width, height, hotx, hoty, handle}``.

The X touchpoint is a swappable source; the PNG writer is self-contained
(zlib) so no imaging library is needed.
"""

from __future__ import annotations

import asyncio
import base64
import ctypes
import ctypes.util
import logging
import struct
import zlib
from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np

logger = logging.getLogger("selkies_tpu_torch.input.cursor")


@dataclass
class CursorImage:
    width: int
    height: int
    xhot: int
    yhot: int
    serial: int
    rgba: bytes  # width*height*4, row-major RGBA


def encode_png_rgba(rgba: bytes, width: int, height: int) -> bytes:
    """Minimal RGBA PNG writer (filter 0 rows + zlib)."""
    raw = bytearray()
    stride = width * 4
    for y in range(height):
        raw.append(0)
        raw += rgba[y * stride:(y + 1) * stride]

    def chunk(tag: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + tag + payload +
                struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", width, height, 8, 6, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr) +
            chunk(b"IDAT", zlib.compress(bytes(raw), 6)) +
            chunk(b"IEND", b""))


def cursor_to_msg(cur: Optional[CursorImage],
                  size_cap: int = 64) -> Dict[str, Any]:
    """Crop/cap/encode a cursor image into the wire JSON dict."""
    empty = {"curdata": "", "width": 0, "height": 0, "hotx": 0, "hoty": 0,
             "handle": cur.serial if cur else 0}
    if cur is None or cur.width == 0 or cur.height == 0:
        return empty
    img = np.frombuffer(cur.rgba, np.uint8).reshape(cur.height, cur.width, 4)
    alpha = img[:, :, 3]
    ys, xs = np.nonzero(alpha)
    if ys.size == 0:
        return empty
    top, bottom = int(ys.min()), int(ys.max()) + 1
    left, right = int(xs.min()), int(xs.max()) + 1
    img = img[top:bottom, left:right]
    hotx, hoty = cur.xhot - left, cur.yhot - top
    h, w = img.shape[:2]
    if w > size_cap or h > size_cap:
        scale = size_cap / max(w, h)
        nw, nh = max(1, int(w * scale)), max(1, int(h * scale))
        yi = (np.arange(nh) * (h / nh)).astype(np.int64)
        xi = (np.arange(nw) * (w / nw)).astype(np.int64)
        img = img[yi][:, xi]
        hotx, hoty = int(hotx * scale), int(hoty * scale)
        w, h = nw, nh
    png = encode_png_rgba(np.ascontiguousarray(img).tobytes(), w, h)
    return {
        "curdata": base64.b64encode(png).decode("ascii"),
        "width": w, "height": h,
        "hotx": int(hotx), "hoty": int(hoty),
        "handle": cur.serial,
    }


# ---------------------------------------------------------------------------
# sources


class CursorSource:
    def get_cursor(self) -> Optional[CursorImage]:
        raise NotImplementedError

    def pending_change(self) -> bool:
        """True when a cursor-change notification is queued."""
        raise NotImplementedError

    def close(self) -> None:
        pass


class FakeCursorSource(CursorSource):
    """Test source: set .cursor and flip .changed to simulate updates."""

    def __init__(self) -> None:
        self.cursor: Optional[CursorImage] = None
        self.changed = False

    def set_cursor(self, cur: CursorImage) -> None:
        self.cursor = cur
        self.changed = True

    def get_cursor(self) -> Optional[CursorImage]:
        return self.cursor

    def pending_change(self) -> bool:
        if self.changed:
            self.changed = False
            return True
        return False


class _XFixesCursorImage(ctypes.Structure):
    _fields_ = [
        ("x", ctypes.c_short), ("y", ctypes.c_short),
        ("width", ctypes.c_ushort), ("height", ctypes.c_ushort),
        ("xhot", ctypes.c_ushort), ("yhot", ctypes.c_ushort),
        ("cursor_serial", ctypes.c_ulong),
        # pixels are packed ARGB but each stored in an unsigned long
        ("pixels", ctypes.POINTER(ctypes.c_ulong)),
        ("atom", ctypes.c_ulong),
        ("name", ctypes.c_char_p),
    ]


XFIXES_DISPLAY_CURSOR_NOTIFY_MASK = 1 << 0


class XFixesCursorSource(CursorSource):
    """Live cursor shapes from the X server via dlopen'd libXfixes."""

    def __init__(self, display_name: Optional[str] = None) -> None:
        x11_path = ctypes.util.find_library("X11")
        xfixes_path = ctypes.util.find_library("Xfixes")
        if not x11_path or not xfixes_path:
            raise RuntimeError("libX11/libXfixes not available")
        self._x = ctypes.CDLL(x11_path)
        self._xf = ctypes.CDLL(xfixes_path)
        self._x.XOpenDisplay.restype = ctypes.c_void_p
        self._x.XOpenDisplay.argtypes = [ctypes.c_char_p]
        self._x.XDefaultRootWindow.restype = ctypes.c_ulong
        self._x.XDefaultRootWindow.argtypes = [ctypes.c_void_p]
        self._x.XPending.argtypes = [ctypes.c_void_p]
        self._x.XNextEvent.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        self._x.XFree.argtypes = [ctypes.c_void_p]
        self._xf.XFixesQueryExtension.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int)]
        self._xf.XFixesGetCursorImage.restype = \
            ctypes.POINTER(_XFixesCursorImage)
        self._xf.XFixesGetCursorImage.argtypes = [ctypes.c_void_p]
        self._xf.XFixesSelectCursorInput.argtypes = [
            ctypes.c_void_p, ctypes.c_ulong, ctypes.c_ulong]
        name = display_name.encode() if display_name else None
        self._dpy = self._x.XOpenDisplay(name)
        if not self._dpy:
            raise RuntimeError("cannot open X display")
        ev_base = ctypes.c_int()
        err_base = ctypes.c_int()
        if not self._xf.XFixesQueryExtension(
                self._dpy, ctypes.byref(ev_base), ctypes.byref(err_base)):
            raise RuntimeError("XFIXES extension missing")
        self._cursor_notify_event = ev_base.value + 1  # XFixesCursorNotify
        root = self._x.XDefaultRootWindow(self._dpy)
        self._xf.XFixesSelectCursorInput(
            self._dpy, root, XFIXES_DISPLAY_CURSOR_NOTIFY_MASK)

    def get_cursor(self) -> Optional[CursorImage]:
        img_ptr = self._xf.XFixesGetCursorImage(self._dpy)
        if not img_ptr:
            return None
        img = img_ptr.contents
        w, h = img.width, img.height
        n = w * h
        # unpack long-per-pixel ARGB → RGBA bytes
        px = np.ctypeslib.as_array(img.pixels, shape=(n,)).astype(np.uint32)
        rgba = np.empty((n, 4), np.uint8)
        rgba[:, 0] = (px >> 16) & 0xFF
        rgba[:, 1] = (px >> 8) & 0xFF
        rgba[:, 2] = px & 0xFF
        rgba[:, 3] = (px >> 24) & 0xFF
        out = CursorImage(w, h, img.xhot, img.yhot,
                          int(img.cursor_serial), rgba.tobytes())
        self._x.XFree(img_ptr)
        return out

    def pending_change(self) -> bool:
        saw = False
        while self._x.XPending(self._dpy) > 0:
            buf = ctypes.create_string_buffer(192)  # sizeof(XEvent)
            self._x.XNextEvent(self._dpy, buf)
            ev_type = struct.unpack_from("i", buf.raw, 0)[0]
            if ev_type == self._cursor_notify_event:
                saw = True
        return saw

    def close(self) -> None:
        if self._dpy:
            self._x.XCloseDisplay(self._dpy)
            self._dpy = None


class CursorMonitor:
    """Poll a source at ~50 Hz; emit payloads on serial change."""

    def __init__(self, source: CursorSource, on_cursor, size_cap: int = 64,
                 interval: float = 0.02) -> None:
        self.source = source
        self.on_cursor = on_cursor
        self.size_cap = size_cap
        self.interval = interval
        self._last_serial: Optional[int] = None
        self.running = False

    def _emit_current(self) -> None:
        cur = self.source.get_cursor()
        if cur is not None and cur.serial != self._last_serial:
            self._last_serial = cur.serial
            self.on_cursor(cursor_to_msg(cur, self.size_cap))

    async def run(self) -> None:
        self.running = True
        try:
            self._emit_current()
        except Exception as e:
            logger.warning("initial cursor fetch failed: %s", e)
        while self.running:
            try:
                if self.source.pending_change():
                    self._emit_current()
            except asyncio.CancelledError:
                raise
            except Exception as e:
                logger.debug("cursor poll error: %s", e)
            await asyncio.sleep(self.interval)

    def stop(self) -> None:
        self.running = False


def open_cursor_source() -> CursorSource:
    try:
        return XFixesCursorSource()
    except Exception as e:
        logger.info("XFixes unavailable (%s); using FakeCursorSource", e)
        return FakeCursorSource()

"""X11 screen capture via ctypes (libX11/libXext), no compiled deps.

Capability parity with pixelflux's capture half (XShm grab of a region,
consumed by the reference at selkies.py:2897-2904). Two paths:

  * XShm (MIT-SHM) when available — zero-copy into a shared segment;
  * plain ``XGetImage`` fallback.

Both deliver BGRX and are converted to the encoder's RGB uint8 layout with a
single numpy slice. Damage detection is not needed here: the encoders do
dense per-stripe damage on the card (encoder/jpeg.py), which replaces
XDamage. The port's copy of ``selkies_tpu/capture/x11.py``.

This module is import-safe on hosts with no X11; ``X11Source.available()``
reports usability.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import os
from typing import Optional

import numpy as np

from .base import FrameSource


class _XImage(ctypes.Structure):
    _fields_ = [
        ("width", ctypes.c_int),
        ("height", ctypes.c_int),
        ("xoffset", ctypes.c_int),
        ("format", ctypes.c_int),
        ("data", ctypes.POINTER(ctypes.c_char)),
        ("byte_order", ctypes.c_int),
        ("bitmap_unit", ctypes.c_int),
        ("bitmap_bit_order", ctypes.c_int),
        ("bitmap_pad", ctypes.c_int),
        ("depth", ctypes.c_int),
        ("bytes_per_line", ctypes.c_int),
        ("bits_per_pixel", ctypes.c_int),
        ("red_mask", ctypes.c_ulong),
        ("green_mask", ctypes.c_ulong),
        ("blue_mask", ctypes.c_ulong),
    ]


def _load_x11():
    name = ctypes.util.find_library("X11") or "libX11.so.6"
    try:
        lib = ctypes.CDLL(name)
    except OSError:
        return None
    lib.XOpenDisplay.restype = ctypes.c_void_p
    lib.XOpenDisplay.argtypes = [ctypes.c_char_p]
    lib.XDefaultRootWindow.restype = ctypes.c_ulong
    lib.XDefaultRootWindow.argtypes = [ctypes.c_void_p]
    lib.XGetImage.restype = ctypes.POINTER(_XImage)
    lib.XGetImage.argtypes = [
        ctypes.c_void_p, ctypes.c_ulong, ctypes.c_int, ctypes.c_int,
        ctypes.c_uint, ctypes.c_uint, ctypes.c_ulong, ctypes.c_int,
    ]
    lib.XDestroyImage.argtypes = [ctypes.POINTER(_XImage)]
    lib.XCloseDisplay.argtypes = [ctypes.c_void_p]
    return lib


_ALL_PLANES = 0xFFFFFFFFFFFFFFFF
_ZPIXMAP = 2


class X11Source(FrameSource):
    """Capture a region of the X11 root window as RGB frames."""

    def __init__(
        self,
        width: int,
        height: int,
        fps: float = 60.0,
        x: int = 0,
        y: int = 0,
        display: Optional[str] = None,
    ) -> None:
        super().__init__(width, height, fps)
        self.x, self.y = x, y
        self._display_name = display or os.environ.get("DISPLAY", "")
        self._lib = None
        self._dpy = None
        self._root = None

    @staticmethod
    def available(display: Optional[str] = None) -> bool:
        name = display or os.environ.get("DISPLAY")
        if not name:
            return False
        lib = _load_x11()
        if lib is None:
            return False
        dpy = lib.XOpenDisplay(name.encode())
        if not dpy:
            return False
        lib.XCloseDisplay(dpy)
        return True

    def start(self) -> None:
        self._lib = _load_x11()
        if self._lib is None:
            raise RuntimeError("libX11 not found")
        self._dpy = self._lib.XOpenDisplay(
            self._display_name.encode() if self._display_name else None)
        if not self._dpy:
            raise RuntimeError(f"cannot open display {self._display_name!r}")
        self._root = self._lib.XDefaultRootWindow(self._dpy)

    def stop(self) -> None:
        if self._dpy:
            self._lib.XCloseDisplay(self._dpy)
            self._dpy = None

    def next_frame(self) -> Optional[np.ndarray]:
        if not self._dpy:
            self.start()
        img_p = self._lib.XGetImage(
            self._dpy, self._root, self.x, self.y,
            self.width, self.height, _ALL_PLANES, _ZPIXMAP)
        if not img_p:
            return None
        img = img_p.contents
        try:
            if img.bits_per_pixel != 32:
                raise RuntimeError(
                    f"unsupported bits_per_pixel {img.bits_per_pixel}")
            n = img.bytes_per_line * img.height
            buf = ctypes.string_at(img.data, n)
            arr = np.frombuffer(buf, dtype=np.uint8).reshape(
                img.height, img.bytes_per_line // 4, 4)[:, : self.width]
            # X11 ZPixmap on little-endian is BGRX
            return np.ascontiguousarray(arr[:, :, 2::-1])
        finally:
            self._lib.XDestroyImage(img_p)

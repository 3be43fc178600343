"""X11 injection backends.

The reference injects input through python-xlib XTEST plus ``xdotool``
subprocess fallbacks (input_handler.py:1063-1160, :1203-1297).  We get the
same capability without the python-xlib dependency by dlopen-ing
``libX11``/``libXtst`` through ctypes at runtime; when no X display is
reachable (tests, CI) a ``FakeX11Backend`` records the exact event stream so
handler logic is fully testable.

X button numbering (X11 core protocol): 1=left 2=middle 3=right 4=scroll-up
5=scroll-down 6=scroll-left 7=scroll-right 8=back 9=forward.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import logging
import threading
from typing import List, Optional, Tuple

from .keysyms import is_unicode_keysym, keysym_to_name

logger = logging.getLogger("selkies_tpu_torch.input.x11")


class X11Backend:
    """Interface every injection backend implements."""

    def key(self, keysym: int, down: bool) -> bool:
        raise NotImplementedError

    def pointer_move(self, x: int, y: int) -> None:
        raise NotImplementedError

    def pointer_move_relative(self, dx: int, dy: int) -> None:
        raise NotImplementedError

    def button(self, button: int, down: bool) -> None:
        raise NotImplementedError

    def type_text(self, text: str) -> bool:
        """Atomically type printable text (clears/ignores held modifiers)."""
        raise NotImplementedError

    def sync(self) -> None:
        pass

    def close(self) -> None:
        pass


# ---------------------------------------------------------------------------
# ctypes XTEST backend


class XTestBackend(X11Backend):
    """Direct XTEST injection via dlopen'd libX11 + libXtst.

    Unicode/unbound keysyms are handled the way xdotool does it: a spare
    keycode (one whose keysym column is empty) is temporarily rebound with
    ``XChangeKeyboardMapping`` and pressed, then released back.
    """

    def __init__(self, display_name: Optional[str] = None) -> None:
        x11_path = ctypes.util.find_library("X11")
        xtst_path = ctypes.util.find_library("Xtst")
        if not x11_path or not xtst_path:
            raise RuntimeError("libX11/libXtst not available")
        self._x = ctypes.CDLL(x11_path)
        self._xtst = ctypes.CDLL(xtst_path)
        self._configure_prototypes()
        name = display_name.encode() if display_name else None
        self._dpy = self._x.XOpenDisplay(name)
        if not self._dpy:
            raise RuntimeError("cannot open X display")
        ev = ctypes.c_int()
        err = ctypes.c_int()
        maj = ctypes.c_int()
        mnr = ctypes.c_int()
        if not self._xtst.XTestQueryExtension(
                self._dpy, ctypes.byref(ev), ctypes.byref(err),
                ctypes.byref(maj), ctypes.byref(mnr)):
            self._x.XCloseDisplay(self._dpy)
            raise RuntimeError("XTEST extension missing")
        self._lock = threading.Lock()
        kc_lo = ctypes.c_int()
        kc_hi = ctypes.c_int()
        self._x.XDisplayKeycodes(
            self._dpy, ctypes.byref(kc_lo), ctypes.byref(kc_hi))
        self._kc_lo, self._kc_hi = kc_lo.value, kc_hi.value
        self._spare_keycode = self._find_spare_keycode()
        self._spare_bound: Optional[int] = None

    def _configure_prototypes(self) -> None:
        x = self._x
        x.XOpenDisplay.restype = ctypes.c_void_p
        x.XOpenDisplay.argtypes = [ctypes.c_char_p]
        x.XCloseDisplay.argtypes = [ctypes.c_void_p]
        x.XFlush.argtypes = [ctypes.c_void_p]
        x.XSync.argtypes = [ctypes.c_void_p, ctypes.c_int]
        x.XKeysymToKeycode.restype = ctypes.c_ubyte
        x.XKeysymToKeycode.argtypes = [ctypes.c_void_p, ctypes.c_ulong]
        x.XDisplayKeycodes.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int)]
        x.XGetKeyboardMapping.restype = ctypes.POINTER(ctypes.c_ulong)
        x.XGetKeyboardMapping.argtypes = [
            ctypes.c_void_p, ctypes.c_ubyte, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int)]
        x.XChangeKeyboardMapping.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_ulong), ctypes.c_int]
        x.XFree.argtypes = [ctypes.c_void_p]
        x.XStringToKeysym.restype = ctypes.c_ulong
        x.XStringToKeysym.argtypes = [ctypes.c_char_p]
        t = self._xtst
        t.XTestQueryExtension.argtypes = [
            ctypes.c_void_p] + [ctypes.POINTER(ctypes.c_int)] * 4
        t.XTestFakeKeyEvent.argtypes = [
            ctypes.c_void_p, ctypes.c_uint, ctypes.c_int, ctypes.c_ulong]
        t.XTestFakeButtonEvent.argtypes = [
            ctypes.c_void_p, ctypes.c_uint, ctypes.c_int, ctypes.c_ulong]
        t.XTestFakeMotionEvent.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_ulong]
        t.XTestFakeRelativeMotionEvent.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_ulong]

    # -- keycode management ----------------------------------------------

    def _find_spare_keycode(self) -> int:
        n = ctypes.c_int()
        count = self._kc_hi - self._kc_lo + 1
        syms = self._x.XGetKeyboardMapping(
            self._dpy, self._kc_lo, count, ctypes.byref(n))
        spare = 0
        if syms:
            per = n.value
            for i in range(count - 1, -1, -1):
                if all(syms[i * per + j] == 0 for j in range(per)):
                    spare = self._kc_lo + i
                    break
            self._x.XFree(syms)
        return spare

    def _bind_spare(self, keysym: int) -> int:
        if not self._spare_keycode:
            return 0
        if self._spare_bound != keysym:
            arr = (ctypes.c_ulong * 2)(keysym, keysym)
            self._x.XChangeKeyboardMapping(
                self._dpy, self._spare_keycode, 2, arr, 1)
            self._x.XSync(self._dpy, 0)
            self._spare_bound = keysym
        return self._spare_keycode

    def _keysym_to_keycode(self, keysym: int) -> int:
        # Unicode keysyms carry the 0x01000000 flag; the X server stores
        # them the same way, so try the direct lookup first.
        kc = self._x.XKeysymToKeycode(self._dpy, keysym)
        if kc:
            return kc
        if is_unicode_keysym(keysym):
            # Latin-1 codepoints double as legacy keysyms.
            cp = keysym & 0x00FFFFFF
            if cp <= 0xFF:
                kc = self._x.XKeysymToKeycode(self._dpy, cp)
                if kc:
                    return kc
        return self._bind_spare(keysym)

    # -- backend interface -------------------------------------------------

    def key(self, keysym: int, down: bool) -> bool:
        with self._lock:
            kc = self._keysym_to_keycode(keysym)
            if not kc:
                return False
            self._xtst.XTestFakeKeyEvent(self._dpy, kc, int(down), 0)
            self._x.XFlush(self._dpy)
            return True

    def pointer_move(self, x: int, y: int) -> None:
        with self._lock:
            self._xtst.XTestFakeMotionEvent(self._dpy, -1, x, y, 0)
            self._x.XFlush(self._dpy)

    def pointer_move_relative(self, dx: int, dy: int) -> None:
        with self._lock:
            self._xtst.XTestFakeRelativeMotionEvent(self._dpy, dx, dy, 0)
            self._x.XFlush(self._dpy)

    def button(self, button: int, down: bool) -> None:
        with self._lock:
            self._xtst.XTestFakeButtonEvent(self._dpy, button, int(down), 0)
            self._x.XFlush(self._dpy)

    def type_text(self, text: str) -> bool:
        ok = True
        for ch in text:
            keysym = ord(ch) if ord(ch) <= 0xFF else 0x01000000 | ord(ch)
            ok = self.key(keysym, True) and ok
            ok = self.key(keysym, False) and ok
        return ok

    def sync(self) -> None:
        with self._lock:
            self._x.XSync(self._dpy, 0)

    def close(self) -> None:
        with self._lock:
            if self._dpy:
                self._x.XCloseDisplay(self._dpy)
                self._dpy = None


# ---------------------------------------------------------------------------
# fake backend (tests / headless)


class FakeX11Backend(X11Backend):
    """Records the injected event stream; always succeeds."""

    def __init__(self) -> None:
        self.events: List[Tuple] = []
        self.synced = 0

    def key(self, keysym: int, down: bool) -> bool:
        self.events.append(("key", keysym, down))
        return True

    def pointer_move(self, x: int, y: int) -> None:
        self.events.append(("move", x, y))

    def pointer_move_relative(self, dx: int, dy: int) -> None:
        self.events.append(("rel", dx, dy))

    def button(self, button: int, down: bool) -> None:
        self.events.append(("button", button, down))

    def type_text(self, text: str) -> bool:
        self.events.append(("type", text))
        return True

    def sync(self) -> None:
        self.synced += 1

    # test helpers
    def clear(self) -> None:
        self.events.clear()

    def keys_pressed(self) -> List[int]:
        return [ks for kind, ks, down in self.events
                if kind == "key" and down]


def open_x11_backend(display_name: Optional[str] = None) -> X11Backend:
    """Real XTEST backend when a display is reachable, fake otherwise."""
    try:
        return XTestBackend(display_name)
    except Exception as e:
        logger.info("X display unavailable (%s); using FakeX11Backend", e)
        return FakeX11Backend()


def xkey_name_for(keysym: int) -> Optional[str]:
    return keysym_to_name(keysym)

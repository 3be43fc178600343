"""Input plane: browser events → X11 injection + gamepad emulation.

Parity target: reference ``src/selkies/input_handler.py`` (1,726 LoC) — the
``kd/ku/kr/m/m2/p/js/c*`` wire grammar (input_handler.py:1507 on_message),
XTEST key/mouse injection, clipboard bridging, XFixes cursor monitoring, and
per-pad unix-socket gamepad servers speaking the C interposer protocol
(input_handler.py:118-760).  Fresh design: every OS touchpoint sits behind a
swappable backend (ctypes-dlopen X11, subprocess xclip, or in-memory fake),
so the full handler logic runs under tests with no display.
"""

from .clipboard import (ClipboardBackend, MemoryClipboard, XclipClipboard,
                        open_clipboard_backend)
from .cursor import (CursorImage, CursorMonitor, FakeCursorSource,
                     XFixesCursorSource, cursor_to_msg, open_cursor_source)
from .gamepad import (GamepadManager, GamepadMapper, PadModel, VirtualGamepad,
                      XPAD_MODEL, pack_config)
from .handler import InputHandler
from .keysyms import MODIFIER_KEYSYMS, keysym_to_char, keysym_to_name
from .x11 import FakeX11Backend, X11Backend, XTestBackend, open_x11_backend

__all__ = [
    "InputHandler",
    "MODIFIER_KEYSYMS", "keysym_to_name", "keysym_to_char",
    "X11Backend", "XTestBackend", "FakeX11Backend", "open_x11_backend",
    "ClipboardBackend", "MemoryClipboard", "XclipClipboard",
    "open_clipboard_backend",
    "CursorImage", "CursorMonitor", "FakeCursorSource", "XFixesCursorSource",
    "cursor_to_msg", "open_cursor_source",
    "GamepadManager", "GamepadMapper", "PadModel", "VirtualGamepad",
    "XPAD_MODEL", "pack_config",
]

"""Browser input message grammar → X11/gamepad/clipboard actions.

Grammar parity with the reference ``WebRTCInput.on_message``
(input_handler.py:1507-1697):

========  ===================================================================
verb      meaning
========  ===================================================================
pong      RTT probe reply
kd/ku     key down/up by X keysym (modifier tracking; non-alpha printables
          typed atomically to avoid stuck-modifier layouts)
kr        release-all keyboard reset
co,end,T  atomically type text T
m/m2      absolute/relative pointer: x,y,button_mask,scroll_magnitude
p         pointer-visibility toggle
vb/ab     video/audio encoder bitrate request
js        gamepad: c(onnect)/d(isconnect)/b(utton)/a(xis)
cw/cb     clipboard write text / binary (base64)
cr        clipboard read request → broadcast back
cws/cbs,  multipart clipboard write: start (text/binary), data chunk, end
cwd/cbd,
cwe/cbe
_arg_fps  set target framerate
_arg_resize  enable/disable manual resize
_f/_l     client-reported fps / latency
========  ===================================================================

All OS side effects go through injectable backends, so the whole grammar is
unit-testable headless.
"""

from __future__ import annotations

import asyncio
import base64
import io
import logging
import re
import time
from typing import Awaitable, Callable, Optional, Set

from .clipboard import ClipboardBackend, MemoryClipboard
from .gamepad import GamepadManager
from .keysyms import (MODIFIER_KEYSYMS, is_printable_keysym, is_unicode_keysym,
                      keysym_to_char)
from .x11 import FakeX11Backend, X11Backend

logger = logging.getLogger("selkies_tpu_torch.input.handler")

KEYSYM_ALT_L = 0xFFE9
KEYSYM_LEFT = 0xFF51
KEYSYM_RIGHT = 0xFF53

# X core button numbers
BTN_LEFT, BTN_MIDDLE, BTN_RIGHT = 1, 2, 3
SCROLL_UP, SCROLL_DOWN, SCROLL_LEFT, SCROLL_RIGHT = 4, 5, 6, 7


class InputHandler:
    """Routes the client input grammar onto pluggable OS backends."""

    def __init__(
        self,
        backend: Optional[X11Backend] = None,
        clipboard: Optional[ClipboardBackend] = None,
        gamepads: Optional[GamepadManager] = None,
        data_server=None,
        enable_clipboard: str = "true",       # true|in|out|false
        enable_binary_clipboard: bool = True,
    ) -> None:
        self.backend = backend if backend is not None else FakeX11Backend()
        self.clipboard = clipboard if clipboard is not None else MemoryClipboard()
        self.gamepads = gamepads if gamepads is not None else GamepadManager()
        self.data_server = data_server
        self.enable_clipboard = enable_clipboard
        self.enable_binary_clipboard = enable_binary_clipboard

        # keyboard state
        self.active_modifiers: Set[int] = set()
        self.atomically_typed: Set[int] = set()
        self.pressed_keysyms: Set[int] = set()
        # mouse state
        self.button_mask = 0
        self.last_x = 0
        self.last_y = 0
        # ping state
        self.ping_start: Optional[float] = None
        # multipart clipboard receive state
        self._mp_buffer: Optional[io.BytesIO] = None
        self._mp_total = 0
        self._mp_mime = "text/plain"

        # callbacks (wired by main())
        self.on_ping_response: Callable[[float], None] = lambda ms: None
        self.on_pointer_visible: Callable[[bool], None] = lambda v: None
        self.on_video_bitrate: Callable[[int], None] = lambda kbps: None
        self.on_audio_bitrate: Callable[[int], None] = lambda kbps: None
        self.on_set_fps: Callable[[int], None] = lambda fps: None
        self.on_set_enable_resize: Callable[[bool, Optional[str]], None] = \
            lambda enabled, res: None
        self.on_client_fps: Callable[[int], None] = lambda fps: None
        self.on_client_latency: Callable[[int], None] = lambda ms: None
        self.on_clipboard_read: Callable[[bytes, str], Awaitable[None]]
        self.on_clipboard_read = self._default_clipboard_out

    async def _default_clipboard_out(self, data: bytes, mime: str) -> None:
        app = getattr(self.data_server, "app", None)
        if app is not None:
            await app.send_clipboard(
                data.decode("utf-8", "ignore") if mime == "text/plain"
                else data,
                mime_type=mime)

    # ------------------------------------------------------------------
    # dispatch

    async def on_message(self, msg: str, display_id: str = "primary") -> None:
        toks = msg.split(",")
        verb = toks[0]
        try:
            await self._dispatch(verb, toks, msg, display_id)
        except (IndexError, ValueError) as e:
            logger.warning("malformed input message %r: %s", msg[:80], e)

    async def _dispatch(self, verb, toks, msg, display_id) -> None:
        if verb == "pong":
            if self.ping_start is not None:
                rtt_ms = (time.monotonic() - self.ping_start) / 2 * 1000
                self.on_ping_response(round(rtt_ms, 3))
        elif verb == "kd":
            await self.key_down(int(toks[1]))
        elif verb == "ku":
            await self.key_up(int(toks[1]))
        elif verb == "kr":
            await self.reset_keyboard()
        elif verb == "co" and len(toks) > 2 and toks[1] == "end":
            # everything after "co,end," is literal text (may hold commas)
            self.backend.type_text(msg[7:])
        elif verb in ("m", "m2"):
            relative = verb == "m2"
            try:
                x, y, mask, scroll = (int(t) for t in toks[1:5])
            except (ValueError, IndexError):
                x = y = scroll = 0
                mask = self.button_mask
                relative = False
            await self.mouse(x, y, mask, scroll, relative, display_id)
        elif verb == "p":
            self.on_pointer_visible(bool(int(toks[1])))
        elif verb == "vb":
            self.on_video_bitrate(int(toks[1]))
        elif verb == "ab":
            self.on_audio_bitrate(int(toks[1]))
        elif verb == "js":
            await self._on_gamepad(toks)
        elif verb == "cw":
            await self._clipboard_write(
                base64.b64decode(toks[1]), "text/plain")
        elif verb == "cb":
            await self._clipboard_write(
                base64.b64decode(toks[2]), toks[1])
        elif verb == "cr":
            await self._clipboard_read_request()
        elif verb == "cws":
            self._multipart_start(int(toks[1]), "text/plain")
        elif verb == "cbs":
            self._multipart_start(int(toks[2]), toks[1])
        elif verb in ("cwd", "cbd"):
            if self._mp_buffer is not None:
                self._mp_buffer.write(base64.b64decode(toks[1]))
        elif verb in ("cwe", "cbe"):
            await self._multipart_end()
        elif verb == "_arg_fps":
            self.on_set_fps(int(toks[1]))
        elif verb == "_arg_resize":
            if len(toks) == 3:
                enabled = toks[1].lower() == "true"
                res = None
                if re.fullmatch(r"\d+x\d+", toks[2]):
                    w, h = (int(v) + int(v) % 2 for v in toks[2].split("x"))
                    res = f"{w}x{h}"
                self.on_set_enable_resize(enabled, res)
        elif verb == "_f":
            self.on_client_fps(int(toks[1]))
        elif verb == "_l":
            self.on_client_latency(int(toks[1]))
        else:
            logger.debug("unknown input verb %r", verb)

    # ------------------------------------------------------------------
    # keyboard

    async def key_down(self, keysym: int) -> None:
        if keysym in MODIFIER_KEYSYMS:
            self.active_modifiers.add(keysym)
        ch = keysym_to_char(keysym)
        if (is_printable_keysym(keysym) and not self.active_modifiers
                and ch is not None and not ch.isalpha()):
            # bare non-alpha printable: atomic type avoids layout-dependent
            # shift state corruption (reference input_handler.py:1520-1527)
            self.backend.type_text(ch)
            self.atomically_typed.add(keysym)
            return
        if self.backend.key(keysym, True):
            self.pressed_keysyms.add(keysym)

    async def key_up(self, keysym: int) -> None:
        if keysym in MODIFIER_KEYSYMS:
            self.active_modifiers.discard(keysym)
        if keysym in self.atomically_typed:
            self.atomically_typed.discard(keysym)
            return
        self.backend.key(keysym, False)
        self.pressed_keysyms.discard(keysym)

    async def reset_keyboard(self) -> None:
        for keysym in list(self.pressed_keysyms):
            self.backend.key(keysym, False)
        self.pressed_keysyms.clear()
        self.active_modifiers.clear()
        self.atomically_typed.clear()

    # ------------------------------------------------------------------
    # mouse

    def _display_offset(self, display_id: str):
        layouts = getattr(self.data_server, "display_layouts", None)
        if layouts:
            layout = layouts.get(display_id)
            if layout:
                return layout.get("x", 0), layout.get("y", 0)
        return 0, 0

    async def mouse(self, x: int, y: int, mask: int, scroll: int,
                    relative: bool, display_id: str = "primary") -> None:
        if relative:
            self.backend.pointer_move_relative(x, y)
        else:
            ox, oy = self._display_offset(display_id)
            fx, fy = x + ox, y + oy
            if fx != self.last_x or fy != self.last_y:
                self.backend.pointer_move(fx, fy)
            self.last_x, self.last_y = fx, fy

        if mask != self.button_mask:
            await self._apply_button_mask(mask, scroll)
            self.button_mask = mask
        self.backend.sync()

    async def _apply_button_mask(self, mask: int, scroll: int) -> None:
        for bit in range(8):
            flag = 1 << bit
            if (mask ^ self.button_mask) & flag == 0:
                continue
            pressed = bool(mask & flag)
            if bit == 0:
                self.backend.button(BTN_LEFT, pressed)
            elif bit == 1:
                self.backend.button(BTN_MIDDLE, pressed)
            elif bit == 2:
                self.backend.button(BTN_RIGHT, pressed)
            elif bit == 3:
                if scroll > 0:
                    if pressed:
                        self._click_n(SCROLL_UP, scroll)
                elif pressed:     # browser Back = Alt+Left
                    await self._combo(KEYSYM_ALT_L, KEYSYM_LEFT)
            elif bit == 4:
                if scroll > 0:
                    if pressed:
                        self._click_n(SCROLL_DOWN, scroll)
                elif pressed:     # browser Forward = Alt+Right
                    await self._combo(KEYSYM_ALT_L, KEYSYM_RIGHT)
            elif bit == 6:
                if scroll > 0 and pressed:
                    self._click_n(SCROLL_LEFT, scroll)
            elif bit == 7:
                if scroll > 0 and pressed:
                    self._click_n(SCROLL_RIGHT, scroll)

    def _click_n(self, button: int, count: int) -> None:
        for _ in range(max(1, count)):
            self.backend.button(button, True)
            self.backend.button(button, False)

    async def _combo(self, modifier: int, key: int) -> None:
        self.backend.key(modifier, True)
        self.backend.key(key, True)
        self.backend.key(key, False)
        self.backend.key(modifier, False)

    # ------------------------------------------------------------------
    # gamepad

    async def _on_gamepad(self, toks) -> None:
        cmd = toks[1]
        index = int(toks[2])
        if cmd == "c":
            try:
                name = base64.b64decode(toks[3]).decode("latin-1",
                                                        "ignore")[:255]
            except Exception:
                name = f"ClientGamepad{index}"
            num_axes, num_btns = int(toks[4]), int(toks[5])
            await self.gamepads.connect(index, name, num_btns, num_axes)
        elif cmd == "d":
            await self.gamepads.disconnect(index)
        elif cmd == "b":
            self.gamepads.send_button(index, int(toks[3]), float(toks[4]))
        elif cmd == "a":
            self.gamepads.send_axis(index, int(toks[3]), float(toks[4]))
        else:
            logger.debug("unknown gamepad cmd %r", cmd)

    # ------------------------------------------------------------------
    # clipboard

    def _clipboard_in_allowed(self) -> bool:
        return self.enable_clipboard in ("true", "in")

    def _clipboard_out_allowed(self) -> bool:
        return self.enable_clipboard in ("true", "out")

    async def _clipboard_write(self, data: bytes, mime: str) -> None:
        if not self._clipboard_in_allowed():
            logger.warning("inbound clipboard disabled; dropping write")
            return
        if mime != "text/plain" and not self.enable_binary_clipboard:
            logger.warning("binary clipboard disabled; dropping %s", mime)
            return
        await self.clipboard.write(data, mime)

    async def _clipboard_read_request(self) -> None:
        if not self._clipboard_out_allowed():
            logger.warning("outbound clipboard disabled; dropping read")
            return
        data, mime = await self.clipboard.read(
            use_binary=self.enable_binary_clipboard)
        if data:
            await self.on_clipboard_read(data, mime)

    def _multipart_start(self, total: int, mime: str) -> None:
        if not self._clipboard_in_allowed():
            logger.warning("inbound clipboard disabled; dropping multipart")
            return
        self._mp_buffer = io.BytesIO()
        self._mp_total = total
        self._mp_mime = mime

    async def _multipart_end(self) -> None:
        if self._mp_buffer is None:
            return
        data = self._mp_buffer.getvalue()
        self._mp_buffer = None
        if len(data) != self._mp_total:
            logger.error("multipart clipboard size mismatch: %d != %d",
                         len(data), self._mp_total)
            return
        await self._clipboard_write(data, self._mp_mime)

    # ------------------------------------------------------------------
    # outbound clipboard poll (reference: 0.5 s loop input_handler.py:1374)

    async def run_clipboard_poll(self, interval: float = 0.5) -> None:
        last: Optional[bytes] = None
        while True:
            try:
                if self._clipboard_out_allowed():
                    data, mime = await self.clipboard.read(
                        use_binary=self.enable_binary_clipboard)
                    if data and data != last:
                        last = data
                        await self.on_clipboard_read(data, mime)
            except asyncio.CancelledError:
                raise
            except Exception as e:
                logger.debug("clipboard poll error: %s", e)
            await asyncio.sleep(interval)

    async def ping(self, send: Callable[[str], Awaitable[None]]) -> None:
        self.ping_start = time.monotonic()
        await send("ping")

    async def close(self) -> None:
        await self.gamepads.close()
        self.backend.close()

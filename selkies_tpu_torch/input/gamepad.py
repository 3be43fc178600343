"""Virtual gamepad emulation over the interposer unix-socket protocol.

Protocol parity with the reference (input_handler.py:118-760 and
addons/js-interposer/joystick_interposer.c):

* Per pad slot N, two unix-socket servers: ``selkies_js{N}.sock`` (legacy
  joystick API) and ``selkies_event{1000+N}.sock`` (evdev API).
* On connect the server writes one 1360-byte ``js_config_t`` (name[255],
  1 pad, vendor/product/version/num_btns/num_axes u16, btn_map[512] u16,
  axes_map[64] u8, 6 pad), then reads ONE byte: the client's
  ``sizeof(long)`` (4 or 8) which fixes the timeval width of subsequent
  evdev ``input_event`` structs.
* Events: js sockets get ``struct js_event {u32 time_ms; s16 value;
  u8 type; u8 number}``; evdev sockets get ``struct input_event`` followed
  by a ``SYN_REPORT``.

The browser side speaks the W3C "standard gamepad" layout; we present a
Linux ``xpad``-style Xbox-360 controller to the apps, so the mapper below
translates W3C indices → evdev codes.
"""

from __future__ import annotations

import asyncio
import logging
import os
import struct
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

logger = logging.getLogger("selkies_tpu_torch.input.gamepad")

# -- evdev constants (linux/input-event-codes.h) -----------------------------

EV_SYN, EV_KEY, EV_REL, EV_ABS = 0x00, 0x01, 0x02, 0x03
SYN_REPORT = 0

BTN_A, BTN_B, BTN_X, BTN_Y = 0x130, 0x131, 0x133, 0x134
BTN_TL, BTN_TR = 0x136, 0x137
BTN_SELECT, BTN_START, BTN_MODE = 0x13A, 0x13B, 0x13C
BTN_THUMBL, BTN_THUMBR = 0x13D, 0x13E

ABS_X, ABS_Y, ABS_Z = 0x00, 0x01, 0x02
ABS_RX, ABS_RY, ABS_RZ = 0x03, 0x04, 0x05
ABS_HAT0X, ABS_HAT0Y = 0x10, 0x11

JS_EVENT_BUTTON, JS_EVENT_AXIS, JS_EVENT_INIT = 0x01, 0x02, 0x80

AXIS_MAX = 32767
AXIS_MIN = -32767

# -- interposer config struct -------------------------------------------------

NAME_LEN = 255
MAX_BTNS = 512
MAX_AXES = 64
CONFIG_STRUCT_SIZE = 1360
# name[255] | 1 align pad | 5×u16 | btn_map[512]×u16 | axes_map[64]×u8 | 6 pad
_CONFIG_FMT = f"={NAME_LEN}sx5H{MAX_BTNS}H{MAX_AXES}B6x"
assert struct.calcsize(_CONFIG_FMT) == CONFIG_STRUCT_SIZE


@dataclass(frozen=True)
class PadModel:
    """The virtual controller we expose to applications."""
    name: str
    vendor: int
    product: int
    version: int
    buttons: Tuple[int, ...]   # internal button index → evdev key code
    axes: Tuple[int, ...]      # internal axis index → evdev abs code


#: Linux xpad-driver presentation of an Xbox-360 controller.
XPAD_MODEL = PadModel(
    name="Microsoft X-Box 360 pad",
    vendor=0x045E, product=0x028E, version=0x0114,
    buttons=(BTN_A, BTN_B, BTN_X, BTN_Y, BTN_TL, BTN_TR,
             BTN_SELECT, BTN_START, BTN_MODE, BTN_THUMBL, BTN_THUMBR),
    axes=(ABS_X, ABS_Y, ABS_Z, ABS_RX, ABS_RY, ABS_RZ,
          ABS_HAT0X, ABS_HAT0Y),
)

# W3C standard-gamepad button index → internal button index
_W3C_BTN_TO_INTERNAL = {0: 0, 1: 1, 2: 2, 3: 3, 4: 4, 5: 5,
                        8: 6, 9: 7, 16: 8, 10: 9, 11: 10}
# W3C buttons 6/7 are the analog triggers → internal axes 2 (ABS_Z) / 5 (ABS_RZ)
_W3C_TRIGGER_TO_AXIS = {6: 2, 7: 5}
# W3C buttons 12-15 are the d-pad → (internal hat axis, direction)
_W3C_DPAD_TO_HAT = {12: (7, -1), 13: (7, 1), 14: (6, -1), 15: (6, 1)}
# W3C axes 0-3 are the sticks → internal axes 0,1 (left) 3,4 (right)
_W3C_AXIS_TO_INTERNAL = {0: 0, 1: 1, 2: 3, 3: 4}

_TRIGGER_AXES = frozenset({2, 5})
_HAT_AXES = frozenset({6, 7})


def pack_config(model: PadModel) -> bytes:
    name = model.name.encode("utf-8")[:NAME_LEN - 1]
    btn_map = list(model.buttons)[:MAX_BTNS]
    axes_map = list(model.axes)[:MAX_AXES]
    return struct.pack(
        _CONFIG_FMT, name,
        model.vendor, model.product, model.version,
        len(btn_map), len(axes_map),
        *(btn_map + [0] * (MAX_BTNS - len(btn_map))),
        *(axes_map + [0] * (MAX_AXES - len(axes_map))))


def pack_js_event(ev_type: int, number: int, value: int,
                  ts_ms: Optional[int] = None) -> bytes:
    if ts_ms is None:
        ts_ms = int(time.time() * 1000) & 0xFFFFFFFF
    return struct.pack("=IhBB", ts_ms, int(value), ev_type, number)


def pack_evdev_event(ev_type: int, code: int, value: int,
                     arch_bits: int = 64) -> bytes:
    """input_event + SYN_REPORT with arch-correct timeval width."""
    now = time.time()
    sec, usec = int(now), int((now % 1.0) * 1_000_000)
    fmt = "=qqHHi" if arch_bits == 64 else "=llHHi"
    return (struct.pack(fmt, sec, usec, ev_type, code, int(value)) +
            struct.pack(fmt, sec, usec, EV_SYN, SYN_REPORT, 0))


def normalize_axis(value: float, *, trigger: bool = False, hat: bool = False,
                   for_js: bool = False) -> int:
    """Client float → device int. Triggers 0..1, sticks -1..1, hats -1/0/1."""
    if hat:
        v = int(max(-1, min(1, round(value))))
        return v * AXIS_MAX if for_js else v
    if trigger:
        return int(AXIS_MIN + max(0.0, min(1.0, value)) * (AXIS_MAX - AXIS_MIN))
    v = max(-1.0, min(1.0, value))
    return int(AXIS_MIN + ((v + 1.0) / 2.0) * (AXIS_MAX - AXIS_MIN))


@dataclass
class MappedEvent:
    """One abstract device event, packable for either socket flavor."""
    is_button: bool
    index: int          # internal button/axis index (js `number` field)
    evdev_code: int
    value_js: int
    value_evdev: int

    def js_bytes(self) -> bytes:
        t = JS_EVENT_BUTTON if self.is_button else JS_EVENT_AXIS
        return pack_js_event(t, self.index, self.value_js)

    def evdev_bytes(self, arch_bits: int) -> bytes:
        t = EV_KEY if self.is_button else EV_ABS
        return pack_evdev_event(t, self.evdev_code, self.value_evdev,
                                arch_bits)


class GamepadMapper:
    """W3C standard-gamepad events → xpad-model device events."""

    def __init__(self, model: PadModel = XPAD_MODEL) -> None:
        self.model = model

    def map_button(self, w3c_index: int, value: float
                   ) -> Optional[MappedEvent]:
        if w3c_index in _W3C_TRIGGER_TO_AXIS:
            axis = _W3C_TRIGGER_TO_AXIS[w3c_index]
            return MappedEvent(
                is_button=False, index=axis,
                evdev_code=self.model.axes[axis],
                value_js=normalize_axis(value, trigger=True, for_js=True),
                value_evdev=normalize_axis(value, trigger=True))
        if w3c_index in _W3C_DPAD_TO_HAT:
            axis, direction = _W3C_DPAD_TO_HAT[w3c_index]
            hat = direction if value > 0.5 else 0
            return MappedEvent(
                is_button=False, index=axis,
                evdev_code=self.model.axes[axis],
                value_js=normalize_axis(hat, hat=True, for_js=True),
                value_evdev=normalize_axis(hat, hat=True))
        internal = _W3C_BTN_TO_INTERNAL.get(w3c_index)
        if internal is None or internal >= len(self.model.buttons):
            return None
        pressed = 1 if value > 0.5 else 0
        return MappedEvent(
            is_button=True, index=internal,
            evdev_code=self.model.buttons[internal],
            value_js=pressed, value_evdev=pressed)

    def map_axis(self, w3c_index: int, value: float) -> Optional[MappedEvent]:
        internal = _W3C_AXIS_TO_INTERNAL.get(w3c_index)
        if internal is None or internal >= len(self.model.axes):
            return None
        return MappedEvent(
            is_button=False, index=internal,
            evdev_code=self.model.axes[internal],
            value_js=normalize_axis(value, for_js=True),
            value_evdev=normalize_axis(value))


@dataclass
class _Client:
    writer: asyncio.StreamWriter
    arch_bits: int = 64


class VirtualGamepad:
    """One pad slot: mapper + js/evdev unix-socket servers + event fan-out."""

    def __init__(self, index: int, socket_dir: str = "/tmp",
                 model: PadModel = XPAD_MODEL) -> None:
        self.index = index
        self.js_path = os.path.join(socket_dir, f"selkies_js{index}.sock")
        self.ev_path = os.path.join(
            socket_dir, f"selkies_event{1000 + index}.sock")
        self.mapper = GamepadMapper(model)
        self.model = model
        self._config = pack_config(model)
        self._js_clients: List[_Client] = []
        self._ev_clients: List[_Client] = []
        self._servers: List[asyncio.base_events.Server] = []
        self._queue: asyncio.Queue = asyncio.Queue()
        self._pump_task: Optional[asyncio.Task] = None
        self.running = False

    # -- lifecycle ---------------------------------------------------------

    async def start(self) -> None:
        if self.running:
            return
        self.running = True
        for path, is_ev in ((self.js_path, False), (self.ev_path, True)):
            if os.path.exists(path):
                os.unlink(path)
            server = await asyncio.start_unix_server(
                lambda r, w, ev=is_ev: self._on_client(r, w, ev), path=path)
            self._servers.append(server)
        self._pump_task = asyncio.create_task(self._pump())
        logger.info("gamepad %d listening on %s / %s",
                    self.index, self.js_path, self.ev_path)

    async def stop(self) -> None:
        self.running = False
        for server in self._servers:
            server.close()
            await server.wait_closed()
        self._servers.clear()
        if self._pump_task:
            self._queue.put_nowait(None)
            try:
                await asyncio.wait_for(self._pump_task, timeout=2.0)
            except asyncio.TimeoutError:
                self._pump_task.cancel()
            self._pump_task = None
        for c in self._js_clients + self._ev_clients:
            c.writer.close()
        self._js_clients.clear()
        self._ev_clients.clear()
        for path in (self.js_path, self.ev_path):
            if os.path.exists(path):
                try:
                    os.unlink(path)
                except OSError:
                    pass

    @property
    def client_count(self) -> int:
        return len(self._js_clients) + len(self._ev_clients)

    # -- socket handling ---------------------------------------------------

    async def _on_client(self, reader: asyncio.StreamReader,
                         writer: asyncio.StreamWriter, is_ev: bool) -> None:
        clients = self._ev_clients if is_ev else self._js_clients
        client = _Client(writer)
        try:
            writer.write(self._config)
            await writer.drain()
            arch_byte = await reader.readexactly(1)
            client.arch_bits = arch_byte[0] * 8
            clients.append(client)
            logger.info("gamepad %d %s client connected (%d-bit)",
                        self.index, "evdev" if is_ev else "js",
                        client.arch_bits)
            while self.running and not writer.is_closing():
                # the interposer never writes again; poll for hangup
                try:
                    data = await asyncio.wait_for(reader.read(64), timeout=0.5)
                    if not data:
                        break
                except asyncio.TimeoutError:
                    continue
        except (asyncio.IncompleteReadError, ConnectionError):
            pass
        finally:
            if client in clients:
                clients.remove(client)
            writer.close()

    # -- event path --------------------------------------------------------

    def send_button(self, w3c_index: int, value: float) -> None:
        ev = self.mapper.map_button(w3c_index, value)
        if ev is not None and self.running:
            self._queue.put_nowait(ev)

    def send_axis(self, w3c_index: int, value: float) -> None:
        ev = self.mapper.map_axis(w3c_index, value)
        if ev is not None and self.running:
            self._queue.put_nowait(ev)

    async def _pump(self) -> None:
        while self.running:
            ev = await self._queue.get()
            if ev is None:
                break
            js_data = ev.js_bytes()
            for c in list(self._js_clients):
                try:
                    c.writer.write(js_data)
                    await c.writer.drain()
                except ConnectionError:
                    if c in self._js_clients:
                        self._js_clients.remove(c)
            for c in list(self._ev_clients):
                try:
                    c.writer.write(ev.evdev_bytes(c.arch_bits))
                    await c.writer.drain()
                except ConnectionError:
                    if c in self._ev_clients:
                        self._ev_clients.remove(c)


class GamepadManager:
    """Lifecycle for up to ``num_slots`` virtual pads (reference: 4)."""

    def __init__(self, num_slots: int = 4, socket_dir: str = "/tmp") -> None:
        self.num_slots = num_slots
        self.socket_dir = socket_dir
        self.pads: Dict[int, VirtualGamepad] = {}

    async def connect(self, index: int, client_name: str = "",
                      num_btns: int = 17, num_axes: int = 4
                      ) -> Optional[VirtualGamepad]:
        if not (0 <= index < self.num_slots):
            logger.error("gamepad index %d out of range", index)
            return None
        pad = self.pads.get(index)
        if pad is None:
            pad = VirtualGamepad(index, self.socket_dir)
            self.pads[index] = pad
        if not pad.running:
            await pad.start()
        return pad

    async def disconnect(self, index: int) -> None:
        pad = self.pads.get(index)
        if pad is not None:
            await pad.stop()

    def send_button(self, index: int, w3c_index: int, value: float) -> None:
        pad = self.pads.get(index)
        if pad is not None:
            pad.send_button(w3c_index, value)

    def send_axis(self, index: int, w3c_index: int, value: float) -> None:
        pad = self.pads.get(index)
        if pad is not None:
            pad.send_axis(w3c_index, value)

    async def close(self) -> None:
        for pad in self.pads.values():
            await pad.stop()
        self.pads.clear()

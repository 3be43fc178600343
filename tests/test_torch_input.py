"""The port's input plane (``selkies_tpu_torch/input``) against the JAX
package's: every case of ``tests/test_input.py`` runs on both packages'
``input/``, and a corpus of client messages (the cases' grammar and
``tools/proto_fuzz.gen_message``'s) goes through both handlers with fake
backends, which must inject the same events, hold the same clipboard,
send the same replies and fire the same callbacks."""

import asyncio
import random

import pytest

from torch_port_cases import case_names, load_cases, run_case

pytest.importorskip("jax")

from selkies_tpu import input as jinput  # noqa: E402
from selkies_tpu_torch import input as tinput  # noqa: E402
from tools.proto_fuzz import gen_message  # noqa: E402

MODS = {"jax": load_cases("test_input.py", port=False),
        "port": load_cases("test_input.py", port=True)}
assert MODS["port"].InputHandler is tinput.InputHandler


@pytest.mark.parametrize("pkg", ["jax", "port"])
@pytest.mark.parametrize("case", case_names(MODS["jax"]))
def test_input_case(case, pkg, tmp_path):
    run_case(MODS[pkg], case, {"tmp_path": tmp_path})


def test_package_surface_equals_jax():
    assert tinput.__all__ == jinput.__all__
    from selkies_tpu.input import keysyms as jk
    from selkies_tpu_torch.input import keysyms as tk
    assert {k: tk.keysym_to_name(k) for k in range(0x20, 0x10000)} == \
        {k: jk.keysym_to_name(k) for k in range(0x20, 0x10000)}


class _App:
    def __init__(self):
        self.clipboard = []

    async def send_clipboard(self, data, mime_type="text/plain"):
        self.clipboard.append((data, mime_type))


class _Server:
    def __init__(self):
        self.app = _App()
        self.sent = []

    def broadcast(self, msg):
        self.sent.append(msg)


def _corpus():
    msgs = ["kd,97", "ku,97", "kd,33", "ku,33", "kd,65507", "kd,33",
            "ku,33", "ku,65507", "kr", "co,end,hello, world", "m,10,20,1,0",
            "m,10,20,0,0", "m2,5,-3,0,0", "m,1,1,8,3", "m,1,1,16,0",
            "kd,1712", "kd,269025044", "kd,65457", "ku,65457",
            "cw,aGVsbG8=", "cr", "cws,text/plain,10", "cwd,aGVsbG8=",
            "cwd,d29ybGQ=", "cwe", "cb,image/png,iVBORw0KGgo=", "vb,4000",
            "ab,128000", "_arg_fps,30", "_arg_resize,true,1280x721", "_f,59",
            "_l,12", "p,0", "p,1", "SET_NATIVE_CURSOR_RENDERING,1", "kd,",
            "m,x", "cw,!!!", "", ",", "kd,-5", "m,1e9,2,0,0"]
    rng = random.Random(7)
    while len(msgs) < 400:
        m = gen_message(rng)
        if isinstance(m, str) and not m.startswith(("js", "pong")):
            msgs.append(m)
    return msgs


def _drive(pkg, display):
    server = _Server()
    backend = pkg.FakeX11Backend()
    clip = pkg.MemoryClipboard()
    h = pkg.InputHandler(backend=backend, clipboard=clip,
                         data_server=server, enable_binary_clipboard=True)
    calls = []
    for cb in ("on_pointer_visible", "on_video_bitrate", "on_audio_bitrate",
               "on_set_fps", "on_set_enable_resize", "on_client_fps",
               "on_client_latency"):
        setattr(h, cb, lambda *a, _cb=cb: calls.append((_cb, a)))

    async def run():
        for m in _corpus():
            await h.on_message(m, display)
        held = (sorted(h.pressed_keysyms), h.button_mask)
        await h.close()
        return held, await clip.read()

    held, clipboard = asyncio.run(run())
    return (backend.events, clipboard, server.sent, server.app.clipboard,
            calls, held)


@pytest.mark.parametrize("display", ["primary", "display2"])
def test_message_corpus_gives_the_same_outputs(display):
    jax = _drive(jinput, display)
    port = _drive(tinput, display)
    assert len(jax[0]) > 50
    assert port == jax

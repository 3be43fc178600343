"""Mutational protocol fuzzer for the port's websocket edge.

Drives the port's ``DataStreamingServer.ws_handler`` with garbage,
truncated and mutated text and binary frames through the in-process
``robustness.testing.InProcessClient`` (no network, no ``websockets``
package), while one healthy observer client streams beside it. Hostile
input must cost the hostile client at most its own socket:

* no handler task dies of an unhandled exception;
* the fuzzing session survives every malformed message (with a generous
  error budget): only a deliberate ``KILL`` may end it;
* the healthy observer keeps receiving frames throughout;
* ``_uploads`` is empty once the fuzz clients are gone (no leaked fds or
  partial files).

The corpus is a function of ``--seed`` alone, message for message the
one the repository's ``tools/proto_fuzz.py`` draws. The encoder is a
device-free stand-in (the fuzzer targets the wire edge); the server still
resolves its device, so without a card pass ``--device cpu``::

    python -m selkies_tpu_torch.tools.proto_fuzz --iterations 2000 --seed 7 -v
    python -m selkies_tpu_torch.tools.proto_fuzz --device cpu
"""

from __future__ import annotations

import argparse
import asyncio
import json
import logging
import os
import random
import string
import sys
import tempfile
import time

import numpy as np

from ..robustness.testing import InProcessClient

#: plausible client verbs and argument shapes, from the grammar table in
#: protocol/wire.py: the mutation engine starts from these
_TEMPLATES = (
    "SETTINGS,{json}",
    "CLIENT_FRAME_ACK {int}",
    "r,{int}x{int},{disp}",
    "r,{int}x{int}",
    "s,{float}",
    "cmd,{text}",
    "SET_NATIVE_CURSOR_RENDERING,{bit}",
    "START_VIDEO", "STOP_VIDEO", "START_AUDIO", "STOP_AUDIO",
    "FILE_UPLOAD_START:{path}:{int}",
    "FILE_UPLOAD_END:{path}",
    "FILE_UPLOAD_ERROR:{path}:{text}",
    "cr", "cw,{b64}", "cb,{mime},{b64}",
    "cws,{int}", "cwd,{b64}", "cwe",
    "cbs,{mime},{int}", "cbd,{b64}", "cbe",
    "kd,{int}", "ku,{int}", "kr",
    "m,{int},{int},{int},{int}", "m2,{int},{int},{int},{int}",
    "js,c,{int},{text},{int},{int}", "js,b,{int},{int},{bit}",
    "js,a,{int},{int},{float}", "js,d,{int}",
    "_f {float}", "_l {float}",
    "p,{bit}", "vb,{int}", "ab,{int}", "pong",
)

#: server-to-client verbs a hostile client may try to spoof
_SERVER_VERBS = (
    "KILL go away", "PIPELINE_RESETTING primary", "MODE websockets",
    "VIDEO_STARTED", "VIDEO_STOPPED", "AUDIO_STARTED", "AUDIO_STOPPED",
    "KILL", "PIPELINE_RESETTING display2,extra",
)

_PATHS = ("a.txt", "dir/b.bin", "../evil", "dir/with:colon.txt",
          "/abs/path", "c\x00d", 'quo"te.txt', "." * 64)


def _fill(rng: random.Random, template: str) -> str:
    def text(n=12):
        return "".join(rng.choice(string.printable[:80]) for _ in range(n))

    return (template
            .replace("{json}", rng.choice((
                # every parseable dict carries a non-primary displayId: a
                # well-formed SETTINGS without one takes over the
                # observer's primary display (the reconnect semantics)
                json.dumps({"displayId": rng.choice(("display2", "display3")),
                            "framerate": rng.randrange(-5, 500),
                            "jpeg_quality": rng.randrange(-100, 300)}),
                "{not json", "[]",
                json.dumps({"displayId": "display2",
                            "a": int("9" * rng.randrange(1, 40))}),
                json.dumps({"displayId": "display3", text(4): text(4)}))))
            .replace("{disp}", rng.choice(("primary", "display2", text(6))))
            .replace("{path}", rng.choice(_PATHS))
            .replace("{mime}", rng.choice(("text/plain", "image/png", "x/")))
            .replace("{b64}", rng.choice(("aGVsbG8=", "!!!notb64!!!", "")))
            .replace("{int}", str(rng.randrange(-10**6, 10**6)))
            .replace("{float}", repr(rng.uniform(-1e6, 1e6)))
            .replace("{bit}", rng.choice("01"))
            .replace("{text}", text(rng.randrange(0, 24))))


def _mutate(rng: random.Random, msg: str) -> str:
    ops = rng.randrange(1, 4)
    for _ in range(ops):
        kind = rng.randrange(6)
        if not msg:
            return msg
        if kind == 0:      # truncate
            msg = msg[:rng.randrange(len(msg))]
        elif kind == 1:    # splice junk
            i = rng.randrange(len(msg) + 1)
            msg = msg[:i] + "".join(
                chr(rng.randrange(1, 0x2FF))
                for _ in range(rng.randrange(1, 8))) + msg[i:]
        elif kind == 2:    # duplicate a delimiter
            msg = msg.replace(
                rng.choice(",: "), rng.choice(",: ") * 2, 1)
        elif kind == 3:    # glue a verb onto its args (prefix confusion)
            msg = msg.replace(" ", "", 1).replace(",", "", 1)
        elif kind == 4:    # case flip
            msg = msg.swapcase()
        else:              # oversize one argument
            msg = msg + "A" * rng.randrange(64, 4096)
    return msg


def gen_message(rng: random.Random):
    """One fuzz message: str (text plane) or bytes (binary plane)."""
    roll = rng.random()
    if roll < 0.40:       # plausible grammar, random args
        return _fill(rng, rng.choice(_TEMPLATES))
    if roll < 0.65:       # mutated grammar
        return _mutate(rng, _fill(rng, rng.choice(_TEMPLATES)))
    if roll < 0.75:       # spoofed server verbs
        m = rng.choice(_SERVER_VERBS)
        return _mutate(rng, m) if rng.random() < 0.3 else m
    if roll < 0.85:       # raw garbage text
        n = rng.randrange(0, 2048)
        return "".join(chr(rng.randrange(1, 0x500)) for _ in range(n))
    # binary plane: random, wrong-direction and oversize frames
    sub = rng.random()
    if sub < 0.2:
        return b""
    if sub < 0.5:
        t = rng.randrange(256)
        return bytes([t]) + rng.randbytes(rng.randrange(0, 4096))
    if sub < 0.7:         # file chunk (with or without an upload open)
        return b"\x01" + rng.randbytes(rng.randrange(0, 8192))
    if sub < 0.9:         # mic chunk, now and then over the cap
        n = rng.choice((16, 1024, 300 * 1024))
        return b"\x02" + b"\x00" * n
    return rng.randbytes(rng.randrange(1, 64))


class _FuzzEncoder:
    """Minimal stand-in for the encoder surface the port's capture loop
    drives (``try_submit``/``poll``), yielding the port's
    ``StripeOutput``: the fuzzer targets the wire edge, not the encoder."""

    def __init__(self):
        self._n = 0

    def try_submit(self, frame):
        self._n += 1
        return self._n

    def poll(self):
        if self._n:
            from ..encoder.jpeg import StripeOutput

            n, self._n = self._n, 0
            return [(n, [StripeOutput(y_start=0, height=16,
                                      jpeg=b"\xff\xd8fuzz\xff\xd9",
                                      is_paintover=False)])]
        return []

    def force_keyframe(self):
        pass

    def close(self):
        pass


class _FuzzSource:
    def __init__(self, width, height, fps, **_):
        self.width, self.height = width, height

    def start(self):
        pass

    def stop(self):
        pass

    def next_frame(self):
        return np.zeros((self.height, self.width, 3), np.uint8)


async def _connect(server):
    ws = InProcessClient()
    task = asyncio.create_task(server.ws_handler(ws))
    deadline = time.monotonic() + 10.0
    while time.monotonic() < deadline and len(ws.sent) < 2 and not task.done():
        await asyncio.sleep(0.005)
    return ws, task


async def _drain(ws, task, timeout=20.0):
    """Wait until the handler consumed everything fed so far."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if task.done() or ws._incoming.empty():
            return
        await asyncio.sleep(0.01)


def _was_killed(ws) -> bool:
    return any(isinstance(m, str) and m.startswith("KILL")
               for m in ws.sent)


async def fuzz_session(iterations: int = 500, seed: int = 0,
                       error_budget: int = 10 ** 6,
                       settings_env=None, device=None) -> dict:
    """Run one deterministic fuzz session on the port's server (on
    ``device``: None is the card, and raises without one); returns the
    survival report."""
    from .._device import resolve_device
    from ..server.app import StreamingApp
    from ..server.data_server import DataStreamingServer
    from ..settings import Settings

    device = resolve_device(device)
    # sandbox uploads, honoring a caller-provided dir (pytest tmp_path)
    if not os.environ.get("SELKIES_UPLOAD_DIR"):
        os.environ["SELKIES_UPLOAD_DIR"] = tempfile.mkdtemp(
            prefix="proto_fuzz_uploads_")
    env = {
        "SELKIES_PORT": "0",
        "SELKIES_AUDIO_ENABLED": "false",
        # never let fuzz input reach a shell
        "SELKIES_COMMAND_ENABLED": "false",
        "SELKIES_PROTOCOL_ERROR_BUDGET": str(error_budget),
        "SELKIES_MAX_DISPLAYS": "8",
        "SELKIES_RESIZE_DEBOUNCE_MS": "50",
    }
    env.update(settings_env or {})
    settings = Settings(argv=[], env=env)
    app = StreamingApp(settings)
    server = DataStreamingServer(
        settings, app=app,
        encoder_factory=lambda w, h, s, overrides=None, **kw: _FuzzEncoder(),
        source_factory=_FuzzSource, host="127.0.0.1", device=device)
    app.data_server = server

    rng = random.Random(seed)
    report = {
        "iterations": iterations, "seed": seed,
        "kills": 0, "premature_deaths": 0, "reconnects": 0,
    }
    try:
        observer, obs_task = await _connect(server)
        observer.feed("SETTINGS," + json.dumps({
            "displayId": "primary", "initialClientWidth": 64,
            "initialClientHeight": 48, "framerate": 30}))
        fuzz, fuzz_task = await _connect(server)

        fed = 0
        while fed < iterations:
            for _ in range(min(25, iterations - fed)):
                fuzz.feed(gen_message(rng))
                fed += 1
            await _drain(fuzz, fuzz_task)
            if fuzz_task.done() or fuzz.closed:
                # a deliberate KILL (abuse budget, admission) is the
                # armor working; anything else is a session death
                if _was_killed(fuzz):
                    report["kills"] += 1
                else:
                    report["premature_deaths"] += 1
                await fuzz.close()
                await asyncio.wait_for(fuzz_task, 10.0)
                fuzz, fuzz_task = await _connect(server)
                report["reconnects"] += 1

        # quiesce: the fuzz client leaves; the observer must still stream
        await _drain(fuzz, fuzz_task)
        await fuzz.close()
        await asyncio.wait_for(fuzz_task, 10.0)
        if fuzz_task.exception() is not None:
            report["premature_deaths"] += 1

        n0 = observer.n_frames()
        deadline = time.monotonic() + 15.0
        while time.monotonic() < deadline and observer.n_frames() <= n0:
            await asyncio.sleep(0.05)
        report.update({
            "observer_alive": not observer.closed and not obs_task.done(),
            "observer_frames": observer.n_frames(),
            "observer_streaming": observer.n_frames() > n0,
            "uploads_leaked": len(server._uploads),
            "protocol_errors": server.edge_stats["protocol_errors"],
            "rate_limited": dict(server.edge_stats["rate_limited"]),
            "sessions_rejected": server.edge_stats["sessions_rejected"],
            "reconfigure_runs": server.edge_stats["reconfigure_runs"],
            "reconfigure_coalesced":
                server.edge_stats["reconfigure_coalesced"],
        })
        report["alive"] = bool(
            report["premature_deaths"] == 0
            and report["observer_alive"]
            and report["observer_streaming"]
            and report["uploads_leaked"] == 0)
        await observer.close()
        await asyncio.wait_for(obs_task, 10.0)
        return report
    finally:
        await server.stop()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--iterations", type=int, default=500)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--error-budget", type=int, default=10 ** 6,
                   help="per-connection protocol error budget (small "
                        "values exercise the KILL protocol_abuse path)")
    p.add_argument("--device", default=None,
                   help="the server's device (default: the card)")
    p.add_argument("-v", "--verbose", action="store_true")
    args = p.parse_args(argv)
    logging.basicConfig(
        level=logging.INFO if args.verbose else logging.ERROR)
    report = asyncio.run(fuzz_session(
        iterations=args.iterations, seed=args.seed,
        error_budget=args.error_budget, device=args.device))
    print(json.dumps(report, indent=2))
    return 0 if report["alive"] else 1


if __name__ == "__main__":
    sys.exit(main())

"""The port's reduced data server, driven in process through ws_handler.

An in-process client (async send/close, async iteration, send_nowait)
stands in for the browser; no websockets package is needed. The port's
first-frame 0x03 stripes must equal the JAX server's for the same
synthetic source, byte for byte, and its first 0x04 frame of the
x264enc-striped profile the JAX encoder's."""

import asyncio
import json

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from selkies_tpu_torch.capture.synthetic import SyntheticSource
from selkies_tpu_torch.protocol.wire import unpack_binary
from selkies_tpu_torch.server import data_server as tds
from selkies_tpu_torch.settings import Settings


class Client:
    """Just enough websocket surface for both servers' ws_handler."""

    def __init__(self):
        self.sent = []
        self.closed = False
        self._incoming = asyncio.Queue()

    async def send(self, message):
        if self.closed:
            raise ConnectionError("closed")
        self.sent.append(message)

    def send_nowait(self, message):
        if not self.closed:
            self.sent.append(message)

    def feed(self, message):
        self._incoming.put_nowait(message)

    async def close(self):
        if not self.closed:
            self.closed = True
            self._incoming.put_nowait(None)

    def binary(self):
        return [m for m in self.sent if isinstance(m, (bytes, bytearray))]

    def __aiter__(self):
        return self

    async def __anext__(self):
        m = await self._incoming.get()
        if m is None:
            raise StopAsyncIteration
        return m


W, H = 256, 120
ENV = {"SELKIES_PORT": "0", "SELKIES_AUDIO_ENABLED": "false",
       "SELKIES_TPU_STRIPE_HEIGHT": "64"}
SETTINGS = {"displayId": "primary", "initialClientWidth": W,
            "initialClientHeight": H, "framerate": 30}


def _source(w, h, fps, **_kw):
    return SyntheticSource(w, h, fps, pattern="desktop", seed=5)


def _port_server():
    return tds.DataStreamingServer(Settings(argv=[], env=dict(ENV)),
                                   source_factory=_source, device="cpu",
                                   host="127.0.0.1")


async def _wait(pred, timeout=60.0):
    deadline = asyncio.get_running_loop().time() + timeout
    while asyncio.get_running_loop().time() < deadline:
        if pred():
            return True
        await asyncio.sleep(0.01)
    return False


def _frames(client):
    """{frame_id: [(y_start, payload), ...]} of the 0x03 stripes received."""
    out = {}
    for m in client.binary():
        assert m[0] == 0x03
        f = unpack_binary(m)
        out.setdefault(f.frame_id, []).append((f.y_start, f.payload))
    return out


async def _serve_first_frames(server, n_frames, acks=False):
    ws = Client()
    task = asyncio.create_task(server.ws_handler(ws))
    assert await _wait(lambda: len(ws.sent) >= 2)
    ws.feed("SETTINGS," + json.dumps(SETTINGS))
    assert await _wait(lambda: len(_frames(ws)) >= n_frames)
    if acks:
        for fid in sorted(_frames(ws)):
            ws.feed(f"CLIENT_FRAME_ACK {fid}")
    await asyncio.sleep(0.05)
    return ws, task


async def _close(server, ws, task):
    await ws.close()
    await asyncio.wait_for(task, 10.0)
    await server.stop()


def test_handshake_mode_and_settings():
    async def run():
        server = _port_server()
        ws = Client()
        task = asyncio.create_task(server.ws_handler(ws))
        assert await _wait(lambda: len(ws.sent) >= 2)
        assert ws.sent[0] == "MODE websockets"
        payload = json.loads(ws.sent[1])
        assert payload["type"] == "server_settings"
        from selkies_tpu.settings import Settings as JSettings
        assert payload == JSettings(argv=[], env=dict(ENV)).schema_payload()
        await _close(server, ws, task)
    asyncio.run(run())


def test_first_frame_stripes_byte_identical_to_jax_server():
    from selkies_tpu.server.data_server import DataStreamingServer as JServer
    from selkies_tpu.settings import Settings as JSettings

    async def run():
        jserver = JServer(JSettings(argv=[], env=dict(ENV)),
                          source_factory=_source, host="127.0.0.1")
        jws, jtask = await _serve_first_frames(jserver, 1)
        jframes = _frames(jws)
        await _close(jserver, jws, jtask)

        server = _port_server()
        ws, task = await _serve_first_frames(server, 1)
        frames = _frames(ws)
        await _close(server, ws, task)
        return jframes[1], frames[1]

    want, got = asyncio.run(run())
    assert [y for y, _ in got] == [0, 64]          # every stripe of frame 1
    assert got == want


def test_later_frames_arrive_and_acks_are_taken():
    async def run():
        server = _port_server()
        ws, task = await _serve_first_frames(server, 3, acks=True)
        frames = _frames(ws)
        st = server.display_clients["primary"]
        assert await _wait(lambda: st.bp.acknowledged_frame_id >= 3)
        assert st.bp.send_enabled and st.frames_sent >= 3
        assert "PIPELINE_RESETTING primary" in ws.sent
        await _close(server, ws, task)
        assert not server.display_clients and not server.clients
        return frames

    frames = asyncio.run(run())
    ids = sorted(frames)
    assert ids[:3] == [1, 2, 3]
    for fid in ids:
        for _, payload in frames[fid]:
            assert payload[:2] == b"\xff\xd8" and payload[-2:] == b"\xff\xd9"


def test_stop_and_start_video():
    async def run():
        server = _port_server()
        ws, task = await _serve_first_frames(server, 1)
        ws.feed("STOP_VIDEO")
        assert await _wait(lambda: "VIDEO_STOPPED" in ws.sent)
        st = server.display_clients["primary"]
        assert st.capture_task is None and st.encoder is None
        n = len(ws.binary())
        ws.feed("START_VIDEO")
        assert await _wait(lambda: "VIDEO_STARTED" in ws.sent)
        assert await _wait(lambda: len(ws.binary()) > n)
        await _close(server, ws, task)
    asyncio.run(run())


def test_h264_profiles_are_not_served():
    """x264enc (full frame) is not ported and raises; x264enc-striped is
    served by the pipelined H.264 encoder behind the async driver."""
    s = Settings(argv=[], env=dict(ENV))
    with pytest.raises(NotImplementedError):
        tds.default_encoder_factory(64, 64, s, {"encoder": "x264enc"},
                                    device="cpu")
    enc = tds.default_encoder_factory(64, 64, s,
                                      {"encoder": "x264enc-striped"},
                                      device="cpu")
    try:
        enc.submit(np.zeros((64, 64, 3), np.uint8))
        out = enc.flush()
        assert len(out) == 1 and len(out[0][1]) == 1
        assert out[0][1][0].is_key and out[0][1][0].annexb[:4] == b"\0\0\0\1"
    finally:
        enc.close()
        enc.join(10.0)
    enc = tds.default_encoder_factory(64, 64, s, device="cpu")
    try:
        enc.submit(np.zeros((64, 64, 3), np.uint8))
        out = enc.flush()
        assert len(out) == 1 and len(out[0][1]) == 1
    finally:
        enc.close()


H264_ENV = dict(ENV, SELKIES_ENCODER="x264enc-striped")


def test_x264enc_striped_served_as_0x04_identical_to_jax_encoder():
    """x264enc-striped through ws_handler: 0x04 stripes, the first frame's
    wire bytes equal the JAX package's encoder on the same source frame,
    later frames arrive and are ACKed."""
    from selkies_tpu.encoder.h264 import H264StripeEncoder as JaxEncoder
    from selkies_tpu.protocol import pack_h264_stripe as jax_pack

    first = _source(W, H, 30).next_frame()
    s = Settings(argv=[], env=dict(H264_ENV))
    jenc = JaxEncoder(W, H, stripe_height=64, qp=s.h264_crf.default,
                      paint_over_qp=s.h264_paintover_crf.default)
    want = [jax_pack(1, st.y_start, st.width, st.height, st.annexb,
                     st.is_key) for st in jenc.encode_frame(first)]

    async def run():
        server = tds.DataStreamingServer(
            Settings(argv=[], env=dict(H264_ENV)), source_factory=_source,
            device="cpu", host="127.0.0.1")
        ws = Client()
        task = asyncio.create_task(server.ws_handler(ws))
        assert await _wait(lambda: len(ws.sent) >= 2)
        ws.feed("SETTINGS," + json.dumps(SETTINGS))
        assert await _wait(lambda: len({unpack_binary(m).frame_id
                                        for m in ws.binary()}) >= 3)
        frames = {}
        for m in ws.binary():
            assert m[0] == 0x04
            frames.setdefault(unpack_binary(m).frame_id, []).append(bytes(m))
        for fid in sorted(frames):
            ws.feed(f"CLIENT_FRAME_ACK {fid}")
        st = server.display_clients["primary"]
        assert await _wait(lambda: st.bp.acknowledged_frame_id >= 3)
        await _close(server, ws, task)
        return frames

    frames = asyncio.run(run())
    assert frames[1] == want
    assert [m[1] for m in frames[1]] == [1, 1]          # keyframe flags
    for fid in sorted(frames)[1:]:
        for m in frames[fid]:
            f = unpack_binary(m)
            assert f.payload[:4] == b"\0\0\0\1" and m[1] == 0


def test_server_without_card_or_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    server = tds.DataStreamingServer(Settings(argv=[], env=dict(ENV)),
                                     source_factory=_source)
    with pytest.raises(RuntimeError):
        tds.default_encoder_factory(64, 64, server.settings,
                                    device=server.device)


def _failing_factory(w, h, settings, overrides=None, device=None):
    """The served encoder, with every frame's dispatch raising as a kernel
    that fails to launch would."""
    enc = tds.default_encoder_factory(w, h, settings, overrides, device=device)

    def dispatch_fails(frame):
        raise RuntimeError("kernel launch failed")

    enc.pipe.submit = dispatch_fails
    return enc


def test_encoder_error_ends_the_server():
    """With no degradation ladder, a frame lost to the encoder stops
    run_server, which raises the error, instead of serving no frames."""
    async def run():
        server = tds.DataStreamingServer(
            Settings(argv=[], env=dict(ENV)), encoder_factory=_failing_factory,
            source_factory=_source, device="cpu", host="127.0.0.1")
        serve = asyncio.create_task(server.run_server())
        ws = Client()
        task = asyncio.create_task(server.ws_handler(ws))
        assert await _wait(lambda: len(ws.sent) >= 2)
        ws.feed("SETTINGS," + json.dumps(SETTINGS))
        with pytest.raises(RuntimeError, match="encoder of display primary"):
            await asyncio.wait_for(serve, 30.0)
        assert str(server.fatal.__cause__) == "kernel launch failed"
        assert not ws.binary()
        await _close(server, ws, task)
    asyncio.run(run())


def test_failed_warm_up_ends_the_entry_point(monkeypatch):
    from selkies_tpu_torch.server import main as tmain

    async def serve_forever(self):
        await asyncio.Event().wait()

    monkeypatch.setattr(tmain, "default_encoder_factory", _failing_factory)
    monkeypatch.setattr(tds.DataStreamingServer, "run_server", serve_forever)
    with pytest.raises(RuntimeError, match="warm-up failed"):
        asyncio.run(tmain._amain(Settings(argv=[], env=dict(ENV)),
                                 device="cpu"))

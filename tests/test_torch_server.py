"""The port's reduced data server, driven in process through ws_handler.

An in-process client (async send/close, async iteration, send_nowait)
stands in for the browser; no websockets package is needed. The port's
first-frame 0x03 stripes must equal the JAX server's for the same
synthetic source, byte for byte, its first 0x04 frame of the
x264enc-striped profile the JAX encoder's, and its first 0x00 frame of the
x264enc profile the JAX encoder's full-frame packet."""

import asyncio
import json

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from selkies_tpu_torch.capture.synthetic import SyntheticSource
from selkies_tpu_torch.protocol.wire import unpack_binary
from selkies_tpu_torch.robustness import InProcessClient
from selkies_tpu_torch.server import data_server as tds
from selkies_tpu_torch.settings import Settings


#: the port's in-process websocket stand-in
Client = InProcessClient


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


#: every (encoder, tpu_entropy) pair the JAX factory builds, with the
#: adapter class the port's factory must put in front of it
FACTORY_PAIRS = [
    ("jpeg", None, "AsyncEncodeDriver"),
    ("jpeg", "host", "ThreadedEncoderAdapter"),
    ("x264enc-striped", None, "AsyncEncodeDriver"),
    ("x264enc-striped", "host", "ThreadedEncoderAdapter"),
    ("x264enc", None, "AsyncEncodeDriver"),
    ("x264enc", "host", "ThreadedEncoderAdapter"),
]


@pytest.mark.parametrize("profile,entropy,adapter", FACTORY_PAIRS)
def test_h264_profiles_are_not_served(profile, entropy, adapter):
    """Every (encoder, tpu_entropy) pair is served now, none raises: the
    factory builds it behind the right adapter, which encodes one 96x80
    frame (two 64-row stripes, or one full-frame stripe) and closes. The
    x264enc profile's adapter carries wire_fullframe, the others not."""
    s = Settings(argv=[], env=dict(ENV))
    ov = {"encoder": profile}
    if entropy is not None:
        ov["tpu_entropy"] = entropy
    enc = tds.default_encoder_factory(96, 80, s, ov, device="cpu")
    try:
        assert type(enc).__name__ == adapter
        assert getattr(enc, "wire_fullframe", False) == (profile == "x264enc")
        base = enc.base if adapter == "ThreadedEncoderAdapter" \
            else enc.pipe.base
        assert base.entropy == (entropy or "device")
        assert enc.submit(np.zeros((80, 96, 3), np.uint8)) is not None
        out = enc.flush()
        assert len(out) == 1
        stripes = out[0][1]
        assert len(stripes) == (1 if profile == "x264enc" else 2)
        if profile == "jpeg":
            assert all(x.jpeg[:2] == b"\xff\xd8" for x in stripes)
        else:
            assert all(x.is_key and x.annexb[:4] == b"\0\0\0\1"
                       for x in stripes)
        assert enc.stats()["encode_errors"] == 0
    finally:
        enc.close()
        assert enc.join(10.0)


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
    """The served encoder, whose device rung loses every frame's dispatch
    as a kernel that fails to launch would; the host rung works."""
    enc = tds.default_encoder_factory(w, h, settings, overrides, device=device)

    def dispatch_fails(frame):
        raise RuntimeError("kernel launch failed")

    if hasattr(enc, "pipe"):     # the device rung, behind the async driver
        enc.pipe._submit = dispatch_fails      # what the driver thread calls
    return enc


def test_encoder_error_ends_the_server():
    """An encoder error does not end the server: the frames the device rung
    loses step the display's degradation ladder to the host rung, which
    serves 0x03 stripes on the same socket, and run_server stays up until
    stop()."""
    async def run():
        server = tds.DataStreamingServer(
            Settings(argv=[], env=dict(ENV)), encoder_factory=_failing_factory,
            source_factory=_source, device="cpu", host="127.0.0.1")
        serve = asyncio.create_task(server.run_server())
        ws = Client()
        task = asyncio.create_task(server.ws_handler(ws))
        assert await _wait(lambda: len(ws.sent) >= 2)
        ws.feed("SETTINGS," + json.dumps(SETTINGS))
        assert await _wait(lambda: "primary" in server.display_clients)
        st = server.display_clients["primary"]
        assert await _wait(lambda: st.ladder.rung == "host")
        assert await _wait(lambda: len(_frames(ws)) >= 2)
        assert st.ladder.transitions[0] == "device->host"
        assert st.ladder.failures_total >= 3
        assert type(st.encoder).__name__ == "ThreadedEncoderAdapter"
        assert not st.failed and not ws.closed and not serve.done()
        await _close(server, ws, task)
        await asyncio.wait_for(serve, 10.0)     # stop() ends it
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


FULL_ENV = dict(ENV, SELKIES_ENCODER="x264enc")


def _binary_frames(ws):
    """{frame_id: [raw message, ...]} of the binary frames received."""
    frames = {}
    for m in ws.binary():
        frames.setdefault(unpack_binary(m).frame_id, []).append(bytes(m))
    return frames


async def _serve_h264(env, settings_msg, n_frames):
    server = tds.DataStreamingServer(Settings(argv=[], env=dict(env)),
                                     source_factory=_source, device="cpu",
                                     host="127.0.0.1")
    ws = Client()
    task = asyncio.create_task(server.ws_handler(ws))
    assert await _wait(lambda: len(ws.sent) >= 2)
    ws.feed("SETTINGS," + json.dumps(settings_msg))
    assert await _wait(lambda: len(_binary_frames(ws)) >= n_frames)
    frames = _binary_frames(ws)
    for fid in sorted(frames):
        ws.feed(f"CLIENT_FRAME_ACK {fid}")
    st = server.display_clients[settings_msg["displayId"]]
    assert await _wait(lambda: st.bp.acknowledged_frame_id >= n_frames)
    await _close(server, ws, task)
    return frames


def test_x264enc_served_as_0x00_identical_to_jax_encoder():
    """x264enc through ws_handler: one 0x00 full-frame packet per frame;
    the first equals the JAX package's pack_full_frame of its full-frame
    encoder's output on the same source frame, later ones are P frames."""
    from selkies_tpu.encoder.h264 import H264StripeEncoder as JaxEncoder
    from selkies_tpu.protocol import pack_full_frame as jax_pack

    first = _source(W, H, 30).next_frame()
    s = Settings(argv=[], env=dict(FULL_ENV))
    jenc = JaxEncoder(W, H, fullframe=True, entropy="device",
                      qp=s.h264_crf.default,
                      paint_over_qp=s.h264_paintover_crf.default)
    want = [jax_pack(1, st.annexb, st.is_key)
            for st in jenc.encode_frame(first)]
    frames = asyncio.run(_serve_h264(FULL_ENV, SETTINGS, 3))
    assert len(want) == 1 and frames[1] == want
    assert frames[1][0][:2] == b"\x00\x01"             # 0x00, keyframe
    for fid in sorted(frames)[1:]:
        (m,) = frames[fid]
        f = unpack_binary(m)
        assert m[:2] == b"\x00\x00" and f.payload[:4] == b"\0\0\0\1"


def test_one_stripe_display_under_x264enc_striped_ships_0x04():
    """A display no taller than one stripe has one stripe in striped mode
    too; the profile, not the stripe count, picks the wire type."""
    short = dict(SETTINGS, initialClientHeight=64)
    frames = asyncio.run(_serve_h264(H264_ENV, short, 2))
    for fid in sorted(frames):
        (m,) = frames[fid]
        f = unpack_binary(m)
        assert m[0] == 0x04 and f.y_start == 0 and f.height == 64


@pytest.mark.parametrize("profile,entropy,adapter", [
    ("x264enc", None, "AsyncEncodeDriver"),
    ("x264enc", "host", "ThreadedEncoderAdapter"),
    ("jpeg", None, "AsyncEncodeDriver"),
])
def test_warm_up_encodes_the_configured_profile(monkeypatch, profile, entropy,
                                                adapter):
    """The entry point's warm-up builds the configured profile and rung
    through the factory (SELKIES_TPU_H264_ENTROPY picks the H.264 rung)
    and encodes its two frames, an IDR and a P frame for H.264, without
    an error; its encoder's thread is joined."""
    from selkies_tpu_torch.server import main as tmain

    if entropy is not None:
        monkeypatch.setenv("SELKIES_TPU_H264_ENTROPY", entropy)
    built = []

    def recording_factory(*args, **kwargs):
        enc = tds.default_encoder_factory(*args, **kwargs)
        built.append(enc)
        return enc

    monkeypatch.setattr(tmain, "default_encoder_factory", recording_factory)
    s = Settings(argv=[], env=dict(ENV, SELKIES_ENCODER=profile))
    tmain.warm_default_geometry(s, device="cpu", width=96, height=80)
    (enc,) = built
    assert type(enc).__name__ == adapter
    assert getattr(enc, "wire_fullframe", False) == (profile == "x264enc")
    assert enc.stats()["frames"] == 2 and enc.stats()["encode_errors"] == 0
    assert enc.join(0.0)


def test_late_viewer_of_a_jpeg_host_rung_display_gets_every_stripe():
    """A second client joins a running JPEG display on its host rung
    (ThreadedEncoderAdapter) once the first client's static display has
    gone quiet (first frame and paint-over sent, damage gating sends
    nothing more): the join's keyframe kick refreshes every stripe, so the
    newcomer receives the whole picture.

    This is where the port keeps a divergence from the JAX package: there
    the adapter's keyframe request reaches only an encoder's
    ``request_keyframe`` (selkies_tpu/encoder/pipeline.py:587-592), which
    the JPEG encoder lacks, so the kick does nothing on that rung; the
    port's adapter falls back to ``force_keyframe``."""

    def host_rung(w, h, settings, overrides=None, device=None):
        ov = dict(overrides or {}, tpu_entropy="host")
        return tds.default_encoder_factory(w, h, settings, ov, device=device)

    def static(w, h, fps, **_kw):
        return SyntheticSource(w, h, fps, pattern="static", seed=5)

    async def run():
        server = tds.DataStreamingServer(
            Settings(argv=[], env=dict(ENV)), encoder_factory=host_rung,
            source_factory=static, device="cpu", host="127.0.0.1")
        a, b = Client(), Client()
        task_a = asyncio.create_task(server.ws_handler(a))
        a.feed("SETTINGS," + json.dumps(SETTINGS))
        assert await _wait(lambda: len(_frames(a)) >= 1)
        enc = server.display_clients["primary"].encoder
        assert type(enc).__name__ == "ThreadedEncoderAdapter"
        seen = -1
        loop = asyncio.get_running_loop()
        deadline = loop.time() + 30.0
        while loop.time() < deadline:        # quiet for a whole second
            n = len(a.binary())
            if n == seen:
                break
            seen = n
            for fid in _frames(a):
                a.feed(f"CLIENT_FRAME_ACK {fid}")
            await asyncio.sleep(1.0)
        assert len(a.binary()) == seen
        task_b = asyncio.create_task(server.ws_handler(b))
        assert await _wait(lambda: any(
            sorted(y for y, _ in stripes) == [0, 64]
            for stripes in _frames(b).values()), timeout=30.0)
        await b.close()
        await asyncio.wait_for(task_b, 10.0)
        await _close(server, a, task_a)

    asyncio.run(run())

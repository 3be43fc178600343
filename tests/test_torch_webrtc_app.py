"""The port's WebRTC mode (``selkies_tpu_torch/server/webrtc_app.py``,
``webrtc_main.py``) against the JAX package's.

* The cases of ``tests/test_webrtc_app.py`` (a full session through the
  signaling server with a fake encoder, the bitrate → QP map, the real
  Settings) and the shipped-``webrtc.js`` browser case of
  ``tests/test_webrtc_browser_e2e.py`` run on the port's app, signaling
  server and peer connection.
* The slice as a whole: the JAX app with the JAX ``H264StripeEncoder``
  (its motion search through its plain reference, ``SELKIES_TPU_ME=scan``,
  as the JAX tests run it) and the port's app with the port's encoder on
  the CPU each stream 128x96 frames (one stripe of 96 rows) to a browser
  stand-in ``PeerConnection`` over loopback. The same numpy-seeded moving
  frames go in; the source sets the bitrate to 2 Mbps (QP 34) at frame 6
  and asks for a keyframe at frame 10 from inside ``next_frame()``, so
  both apps apply each change to the same frame. The stand-in's
  depayloaded access units and their RTP timestamps must be equal byte for
  byte and in order, and the one at frame 10 must be an IDR. The JAX
  encoder's programs are compiled over the same frames before its
  session, so the session's 60 s wait is spent streaming, not compiling;
  a session that still stalls names its side and frame in the failure.
* The port's differences from the JAX app: a session whose pipeline
  cannot start ends ``run()`` with that error, and ``stop_pipeline`` waits
  for the media loops.
"""

import asyncio

import numpy as np
import pytest
import torch

from torch_port_cases import case_names, load_cases, run_case

pytest.importorskip("jax")
pytest.importorskip("cryptography")
pytest.importorskip("websockets")

from selkies_tpu.server import webrtc_app as japp  # noqa: E402
from selkies_tpu.webrtc import peerconnection as jpc  # noqa: E402
from selkies_tpu_torch.server import webrtc_app as tapp  # noqa: E402
from selkies_tpu_torch.webrtc import peerconnection as tpc  # noqa: E402

APP_JAX = load_cases("test_webrtc_app.py", port=False)
APP_PORT = load_cases("test_webrtc_app.py", port=True)
E2E_PORT = load_cases("test_webrtc_browser_e2e.py", port=True)


def test_ported_cases_exist():
    assert case_names(APP_PORT) == case_names(APP_JAX) == [
        "test_app_constructs_with_real_settings", "test_bitrate_to_qp_monotone",
        "test_webrtc_app_full_session"]
    assert APP_PORT.WebRTCStreamingApp is tapp.WebRTCStreamingApp
    assert E2E_PORT.WebRTCStreamingApp is tapp.WebRTCStreamingApp
    assert E2E_PORT.PeerConnection is tpc.PeerConnection


@pytest.mark.parametrize("case", case_names(APP_JAX))
def test_webrtc_app_case(case):
    run_case(APP_PORT, case, {})


def test_shipped_webrtc_js_full_session_against_the_port():
    run_case(E2E_PORT,
             "test_shipped_webrtc_js_full_session_against_real_server", {})


def test_bitrate_to_qp_equals_jax():
    for bps in (0, 1, 100, 150_000, 1_000_000, 2_000_000, 3_333_333,
                8_000_000, 64_000_000, 10 ** 9):
        assert tapp.bitrate_to_qp(bps) == japp.bitrate_to_qp(bps)
    assert tapp.bitrate_to_qp(2_000_000) == 34


# ------------------------------------------------------ the slice as a whole

W, H, FPS = 128, 96, 30
N_FRAMES = 14
QP_AT, KEY_AT = 6, 10


class _Settings:
    initial_width = W
    initial_height = H
    framerate = FPS


def _frames():
    """Blocky texture over a gradient, moving by (2, 1) pixels a frame:
    every frame damages the one stripe."""
    rng = np.random.default_rng(23)
    blocks = rng.integers(0, 256, (H // 8 + 4, W // 8 + 4, 3), np.uint8)
    tex = np.repeat(np.repeat(blocks, 8, 0), 8, 1).astype(np.int32)
    yy, xx = np.mgrid[0:tex.shape[0], 0:tex.shape[1]]
    base = np.clip(tex // 2 + (xx + yy)[..., None] // 3, 0, 255)
    return [np.ascontiguousarray(
        base[k:k + H, 2 * k:2 * k + W]).astype(np.uint8)
        for k in range(N_FRAMES)]


class _Source:
    """The frames, one at a time: frame k only after frame k-1 was sent
    (so the pipeline never holds two and never drops one, whatever the
    host's speed); the QP change and the keyframe request are made here,
    before the frame they apply to is returned."""

    def __init__(self, app, frames):
        self.app, self.frames, self.k = app, frames, 0

    def next_frame(self):
        k = self.k
        if k >= len(self.frames) or self.app.frames_sent < k:
            return None
        if k == QP_AT:
            self.app.set_video_bitrate(2_000_000)
        if k == KEY_AT:
            self.app._on_keyframe_request()
        self.k += 1
        return self.frames[k]


async def _stream(app_mod, pc_mod, frames, **app_kw):
    """One session of ``app_mod``'s app to a stand-in browser peer of
    ``pc_mod``: SDP exchanged in-process, every frame streamed. The
    congestion controller's estimates are recorded, not applied, so the
    QP changes only where the source changes it. Returns the stand-in's
    (access unit, RTP timestamp) list, the encoder's last QP and the
    frames the app sent, and None or, where the stand-in did not get
    every frame within the wait, which side stalled at which frame."""
    browser = pc_mod.PeerConnection(interfaces=["127.0.0.1"])
    got = []
    browser.video_receiver().on_frame = lambda f, ts: got.append((f, ts))
    holder = {}
    app = app_mod.WebRTCStreamingApp(
        _Settings(),
        source_factory=lambda w, h, fps: holder.setdefault(
            "src", _Source(app, frames)),
        interfaces=["127.0.0.1"], **app_kw)
    await app.start_pipeline()
    app.pc.on_bitrate = [].append
    await browser.set_remote_description(await app.pc.create_offer(),
                                         "offer")
    await app._on_sdp("answer", await browser.create_answer())
    stall = None
    try:
        for _ in range(1200):
            if len(got) >= N_FRAMES:
                break
            await asyncio.sleep(0.05)
        else:
            src = holder.get("src")
            stall = (f"{app_mod.__name__}: in 60 s the source handed out "
                     f"{src.k if src else 0} frames, the app sent "
                     f"{app.frames_sent}, the browser got {len(got)}")
    finally:
        qp = app.encoder.qp
        await app.stop_pipeline()
        await browser.close()
    return got, qp, app.frames_sent, stall


def _nal_types(au: bytes):
    return [au[i + 4] & 0x1F for i in range(len(au) - 4)
            if au[i:i + 4] == b"\x00\x00\x00\x01"]


def _warm_jax_encoder(frames):
    """Build the JAX session's programs before its session starts: the
    JAX app's default encoder (one stripe over the frame) behind the
    pipeline its video loop builds, fed the session's frames one at a
    time with its QP change and keyframe request. The programs are jitted
    at module level, so the session's own encoder finds them built: on a
    loaded host their first compiles outlasted the session's wait."""
    from selkies_tpu.encoder.h264 import H264StripeEncoder
    from selkies_tpu.encoder.pipeline import PipelinedH264Encoder

    enc = H264StripeEncoder(W, H, stripe_height=H)
    pipe = PipelinedH264Encoder(enc, depth=3, fetch_group=1)
    for k, f in enumerate(frames):
        if k == QP_AT:
            enc.qp = japp.bitrate_to_qp(2_000_000)
        if k == KEY_AT:
            enc.request_keyframe()
        pipe.submit(f)
        pipe.flush()


@pytest.fixture(scope="module")
def sessions():
    """Each app's (access units, last QP, frames sent), and the stalls
    either session met."""
    frames = _frames()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SELKIES_TPU_ME", "scan")
        _warm_jax_encoder(frames)
        *want, want_stall = asyncio.run(_stream(japp, jpc, frames))
    *got, got_stall = asyncio.run(_stream(tapp, tpc, frames, device="cpu"))
    return tuple(want), tuple(got), [s for s in (want_stall, got_stall) if s]


def test_slice_streams_the_jax_apps_bytes(sessions):
    (want, want_qp, want_sent), (got, got_qp, got_sent), stalls = sessions
    assert want_sent == got_sent == N_FRAMES, stalls
    assert len(got) == N_FRAMES, stalls
    assert [ts for _, ts in got] == [k * 90000 // FPS for k in range(N_FRAMES)]
    assert got == want                       # bytes and timestamps, in order
    assert want_qp == got_qp == 34


def _synchronous(frames, qp_at=QP_AT):
    """The port's encoder alone, one frame at a time, with the session's
    QP change and keyframe request."""
    from selkies_tpu_torch.encoder.h264 import H264StripeEncoder

    enc = H264StripeEncoder(W, H, stripe_height=H, device="cpu")
    out = []
    for k, f in enumerate(frames):
        if k == qp_at:
            enc.qp = tapp.bitrate_to_qp(2_000_000)
        if k == KEY_AT:
            enc.request_keyframe()
        out.append(b"".join(s.annexb for s in enc.encode_frame(f)))
    return out


def test_slice_takes_the_new_qp_at_the_frame_it_was_set(sessions):
    _, (got, _, _), _ = sessions
    frames = _frames()
    assert [au for au, _ in got] == _synchronous(frames)
    unchanged = _synchronous(frames, qp_at=None)
    assert unchanged[:QP_AT] == [au for au, _ in got[:QP_AT]]
    assert unchanged[QP_AT] != got[QP_AT][0]


def test_slice_keyframes_where_asked(sessions):
    _, (got, _, _), _ = sessions
    idr = [k for k, (au, _) in enumerate(got) if 5 in _nal_types(au)]
    assert idr == [0, KEY_AT]
    assert all(_nal_types(au)[0] == 7 for au, _ in (got[0], got[KEY_AT]))


# --------------------------------------------------- the port's differences


def test_pipeline_that_cannot_start_ends_run(monkeypatch):
    """No card: the default encoder raises at the session's start, and
    ``run()`` ends with that RuntimeError (the JAX app would leave it in a
    task nobody awaits and keep listening)."""
    from selkies_tpu_torch.rtc import SignalingServer
    from selkies_tpu_torch.settings import Settings

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    async def run():
        server = SignalingServer(addr="127.0.0.1", port=0)
        stask = asyncio.create_task(server.run())
        for _ in range(100):
            if server.server is not None:
                break
            await asyncio.sleep(0.01)
        uri = f"ws://127.0.0.1:{server.port}/ws"
        browser = APP_PORT.SignalingClient(uri, "1")
        await browser.connect()
        btask = asyncio.create_task(browser.start())
        app = tapp.WebRTCStreamingApp(Settings(argv=[], env={}),
                                      interfaces=["127.0.0.1"])
        try:
            with pytest.raises(RuntimeError, match="CUDA"):
                await asyncio.wait_for(app.run(uri, "0", "1"), 30)
            assert isinstance(app.error, RuntimeError)
            assert app.pc is None            # no socket was opened
        finally:
            await app.stop_pipeline()
            await browser.stop()
            await server.stop()
            for t in (stask, btask):
                t.cancel()

    asyncio.run(run())


def test_stop_pipeline_waits_for_the_media_loops():
    async def run():
        browser = tpc.PeerConnection(interfaces=["127.0.0.1"])
        got = []
        browser.video_receiver().on_frame = lambda f, ts: got.append(f)
        app = tapp.WebRTCStreamingApp(
            APP_PORT.Settings(),
            encoder_factory=lambda w, h: APP_PORT.FakeEncoder(),
            source_factory=APP_PORT.FakeSource, interfaces=["127.0.0.1"])
        await app.start_pipeline()
        await browser.set_remote_description(await app.pc.create_offer(),
                                             "offer")
        await app._on_sdp("answer", await browser.create_answer())
        for _ in range(200):
            if got:
                break
            await asyncio.sleep(0.05)
        tasks = list(app._tasks)
        await app.stop_pipeline()
        await browser.close()
        assert got and tasks and all(t.done() for t in tasks)
        assert app.error is None

    asyncio.run(run())

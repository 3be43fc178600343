"""Resize and reconfigure in the port's server, against the JAX server.

* The resize walk: for ``jpeg``, ``x264enc-striped`` and ``x264enc`` a
  served display at 200x120 is resized to 136x64 (a width that is a
  multiple of neither 16 nor 128) and then to 256x120, through
  ``ws_handler``. The JAX server runs the JAX encoders on the CPU, the
  port's server its real encoders with their plain kernel versions; the
  first wire frame of every geometry, and the ``stream_resolution`` and
  ``PIPELINE_RESETTING`` texts, are equal. The JPEG walk ends with a
  storm of 20 ``r,`` messages, coalesced into one reconfiguration. The
  source gives one frame per (re)start, so each geometry encodes one
  frame (one compile per geometry on the JAX side).
* With device-free fake encoders, both servers: ``set_framerate``, the
  owner-only resize, and a lane display (``tpu_mesh``) that changes
  bucket; the real port lanes once more for the bucket change.
* The ports of ``tests/test_server.py``'s upload, resize-reset and xrandr
  layout tests, over a real websocket, on both servers.
"""

import asyncio
import json
import os

import numpy as np
import pytest

pytest.importorskip("jax")
websockets = pytest.importorskip("websockets")

import selkies_tpu.display as jdisp  # noqa: E402
from selkies_tpu import robustness as jrob  # noqa: E402
from selkies_tpu.server import data_server as jds  # noqa: E402
from selkies_tpu.settings import Settings as JSettings  # noqa: E402

import selkies_tpu_torch.display as tdisp  # noqa: E402
from selkies_tpu_torch import robustness as trob  # noqa: E402
from selkies_tpu_torch.capture.synthetic import SyntheticSource  # noqa: E402
from selkies_tpu_torch.protocol.wire import unpack_binary  # noqa: E402
from selkies_tpu_torch.server import data_server as tds  # noqa: E402
from selkies_tpu_torch.settings import Settings as TSettings  # noqa: E402


class _Pkg:
    def __init__(self, name, ds, settings, rob, disp):
        self.name, self.ds, self.Settings = name, ds, settings
        self.rob, self.disp = rob, disp

    def server(self, env, **kw):
        full = {"SELKIES_PORT": "0", "SELKIES_AUDIO_ENABLED": "false",
                "SELKIES_TPU_STRIPE_HEIGHT": "64"}
        full.update(env)
        if self.name == "port":
            kw.setdefault("device", "cpu")
        return self.ds.DataStreamingServer(self.Settings(argv=[], env=full),
                                           host="127.0.0.1", **kw)


JAX = _Pkg("jax", jds, JSettings, jrob, jdisp)
PORT = _Pkg("port", tds, TSettings, trob, tdisp)


async def wait_until(pred, timeout=60.0):
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout
    while loop.time() < deadline:
        if pred():
            return True
        await asyncio.sleep(0.01)
    return False


async def quiet(ws, idle=0.3, timeout=60.0):
    """Wait until ``ws`` has received nothing new for ``idle`` seconds."""
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout
    n, since = len(ws.sent), loop.time()
    while loop.time() < deadline:
        await asyncio.sleep(0.02)
        if len(ws.sent) != n:
            n, since = len(ws.sent), loop.time()
        elif loop.time() - since >= idle:
            return


def is_stats(m):
    """A message of the stats feed (paced by the clock, not the client)."""
    return isinstance(m, str) and m.startswith("{") and json.loads(m)[
        "type"] in ("system_stats", "network_stats", "gpu_stats",
                    "system_health")


# ---------------------------------------------------------------------------
# the resize walk with the real encoders


class OneShotSource:
    """The synthetic desktop's first frame once per (re)start, then no
    frame: each geometry of the walk encodes exactly one frame."""

    def __init__(self, width, height, fps, **_kw):
        self.src = SyntheticSource(width, height, fps, pattern="desktop",
                                   seed=5)
        self.left = 1

    def start(self):
        pass

    def stop(self):
        pass

    def next_frame(self):
        if not self.left:
            return None
        self.left -= 1
        return self.src.next_frame()


PROFILES = ["jpeg", "x264enc-striped", "x264enc"]
WALK = [(200, 120), (136, 64), (256, 120)]
#: the storm: 20 resizes, the last one wins
STORM = [f"r,{200 + 2 * (i % 9)}x{120 + 2 * (i % 4)}" for i in range(19)] \
    + ["r,200x120"]


async def _walk(pkg, profile):
    """Serve one display through ``pkg``'s server and walk it through
    WALK (and the storm, for JPEG); one segment per step: the texts and
    the binary messages received for it, the display's geometry and the
    reconfiguration counters."""
    server = pkg.server({"SELKIES_ENCODER": profile,
                         "SELKIES_RESIZE_DEBOUNCE_MS": "100"},
                        source_factory=OneShotSource)
    ws = pkg.rob.InProcessClient()
    task = asyncio.create_task(server.ws_handler(ws))
    assert await wait_until(lambda: len(ws.sent) >= 2)
    w0, h0 = WALK[0]
    steps = [["SETTINGS," + json.dumps({
        "displayId": "primary", "initialClientWidth": w0,
        "initialClientHeight": h0, "framerate": 30})]]
    steps += [[f"r,{w}x{h},primary"] for w, h in WALK[1:]]
    if profile == "jpeg":
        steps.append(STORM)
    segments = []
    try:
        for msgs in steps:
            mark = len(ws.sent)
            runs0 = server.edge_stats["reconfigure_runs"]
            coal0 = server.edge_stats["reconfigure_coalesced"]
            for m in msgs:
                ws.feed(m)
            assert await wait_until(lambda: any(
                isinstance(m, bytes) for m in ws.sent[mark:])), (pkg, msgs)
            await quiet(ws)
            seg = [m for m in ws.sent[mark:] if not is_stats(m)]
            st = server.display_clients["primary"]
            segments.append({
                "texts": [m for m in seg if isinstance(m, str)],
                "binary": [bytes(m) for m in seg if isinstance(m, bytes)],
                "geometry": (st.width, st.height),
                "runs": server.edge_stats["reconfigure_runs"] - runs0,
                "coalesced":
                    server.edge_stats["reconfigure_coalesced"] - coal0})
    finally:
        await ws.close()
        await asyncio.wait_for(task, 30.0)
        await server.stop()
    return segments


@pytest.fixture(scope="module")
def walks():
    with pytest.MonkeyPatch.context() as mp:
        # the JAX package's plain reference of its motion kernel
        mp.setenv("SELKIES_TPU_ME", "scan")
        return {p: {pkg.name: asyncio.run(_walk(pkg, p))
                    for pkg in (JAX, PORT)} for p in PROFILES}


WIRE = {"jpeg": 0x03, "x264enc-striped": 0x04, "x264enc": 0x00}


@pytest.mark.parametrize("step", range(len(WALK)),
                         ids=[f"{w}x{h}" for w, h in WALK])
@pytest.mark.parametrize("profile", PROFILES)
def test_first_frame_of_each_geometry_equals_jax(walks, profile, step):
    jax, port = walks[profile]["jax"][step], walks[profile]["port"][step]
    assert port["geometry"] == jax["geometry"] == WALK[step]
    assert port["binary"] == jax["binary"]
    frames = [unpack_binary(m) for m in port["binary"]]
    assert frames and {f.frame_id for f in frames} == {1}
    assert {m[0] for m in port["binary"]} == {WIRE[profile]}
    if profile != "jpeg":
        assert all(m[1] == 1 for m in port["binary"])     # IDR after reset


@pytest.mark.parametrize("profile", PROFILES)
def test_resize_texts_equal_jax(walks, profile):
    for step, (jax, port) in enumerate(zip(walks[profile]["jax"],
                                           walks[profile]["port"])):
        assert port["texts"] == jax["texts"], step
        if step:
            w, h = WALK[step] if step < len(WALK) else (200, 120)
            assert port["texts"][-2:] == [json.dumps({
                "type": "stream_resolution", "width": w, "height": h}),
                "PIPELINE_RESETTING primary"]


def test_resize_storm_coalesces_equal_jax(walks):
    jax, port = walks["jpeg"]["jax"][-1], walks["jpeg"]["port"][-1]
    assert port == jax
    assert port["runs"] == 1 and port["coalesced"] == len(STORM) - 1
    assert port["geometry"] == (200, 120)
    assert sum('"stream_resolution"' in t for t in port["texts"]) == \
        len(STORM)
    # the storm ends where the walk began: the same first frame
    assert port["binary"] == walks["jpeg"]["port"][0]["binary"]


# ---------------------------------------------------------------------------
# fake encoders: set_framerate, owner-only resize


class FakeEncoder:
    def __init__(self):
        self.n = 0
        self._ready = []

    def try_submit(self, frame):
        self.n += 1
        self._ready.append((self.n, [trob.FakeStripe()]))
        return self.n

    submit = try_submit

    def poll(self):
        out, self._ready = self._ready, []
        return out

    def flush(self):
        return self.poll()

    def force_keyframe(self):
        pass

    def close(self):
        pass


class FakeSource:
    def __init__(self, width, height, fps, **_kw):
        self.width, self.height = width, height

    def start(self):
        pass

    def stop(self):
        pass

    def next_frame(self):
        return np.zeros((self.height, self.width, 3), np.uint8)


class OneFrameSource(FakeSource):
    """One frame per (re)start: a client that reads no media then has
    nothing backing up in its transport."""

    def __init__(self, width, height, fps, **_kw):
        super().__init__(width, height, fps)
        self.left = 1

    def next_frame(self):
        if not self.left:
            return None
        self.left -= 1
        return super().next_frame()


def fake_server(pkg, source=FakeSource, **env):
    built = []

    def factory(w, h, s, overrides=None, device=None):
        built.append((w, h))
        return FakeEncoder()

    server = pkg.server(dict({"SELKIES_RESIZE_DEBOUNCE_MS": "20"}, **env),
                        encoder_factory=factory, source_factory=source)
    return server, built


GEOM = {"displayId": "primary", "initialClientWidth": 320,
        "initialClientHeight": 240, "framerate": 60}


async def open_client(pkg, server, body=None):
    ws = pkg.rob.InProcessClient()
    task = asyncio.create_task(server.ws_handler(ws))
    assert await wait_until(lambda: len(ws.sent) >= 2)
    if body is not None:
        ws.feed("SETTINGS," + json.dumps(body))
    return ws, task


async def close_client(ws, task):
    await ws.close()
    await asyncio.wait_for(task, 10.0)


def test_set_framerate_restarts_at_the_clamped_rate():
    async def scenario(pkg):
        server, built = fake_server(pkg)
        ws, task = await open_client(pkg, server, GEOM)
        try:
            assert await wait_until(lambda: ws.n_frames() >= 2)
            st = server.display_clients["primary"]
            await server.set_framerate(30)
            rate30 = (st.bp.framerate, st.running_config[1])
            n = ws.n_frames()
            assert await wait_until(lambda: ws.n_frames() >= n + 2)
            await server.set_framerate(100000)
            top = st.bp.framerate
            n = ws.n_frames()
            assert await wait_until(lambda: ws.n_frames() >= n + 2)
            return {"rate30": rate30, "top": top, "built": len(built),
                    "resets": ws.texts().count("PIPELINE_RESETTING primary")}
        finally:
            await close_client(ws, task)
            await server.stop()

    jax = asyncio.run(scenario(JAX))
    port = asyncio.run(scenario(PORT))
    assert port == jax
    assert port["rate30"] == (30.0, 30.0)
    assert port["top"] == float(TSettings(argv=[], env={}).framerate.clamp(
        100000))
    assert port["built"] == 3 and port["resets"] == 3


def test_resize_is_owner_only():
    async def scenario(pkg):
        server, built = fake_server(pkg)
        owner, ot = await open_client(pkg, server, GEOM)
        viewer, vt = await open_client(pkg, server)
        try:
            assert await wait_until(lambda: owner.n_frames() >= 1)
            st = server.display_clients["primary"]
            viewer.feed("r,640x480,primary")
            viewer.feed("r,640x480")
            await asyncio.sleep(0.2)
            after_viewer = (st.width, st.height, len(built))
            owner.feed("r,641x479")
            assert await wait_until(lambda: len(built) == 2)
            texts = [t for t in viewer.texts()
                     if "stream_resolution" in t or "RESETTING" in t]
            return {"after_viewer": after_viewer, "built": built,
                    "geometry": (st.width, st.height), "viewer": texts,
                    "runs": server.edge_stats["reconfigure_runs"]}
        finally:
            await close_client(viewer, vt)
            await close_client(owner, ot)
            await server.stop()

    jax = asyncio.run(scenario(JAX))
    port = asyncio.run(scenario(PORT))
    assert port == jax
    assert port["after_viewer"] == (320, 240, 1)
    assert port["geometry"] == (640, 478) and port["built"][-1] == (640, 478)
    assert port["viewer"] == [
        "PIPELINE_RESETTING primary",
        '{"type": "stream_resolution", "width": 640, "height": 478}',
        "PIPELINE_RESETTING primary"]


# ---------------------------------------------------------------------------
# a lane display that changes bucket


LANE_ENV = {"SELKIES_SECOND_SCREEN": "true", "SELKIES_MAX_DISPLAYS": "0",
            "SELKIES_TPU_MESH": "session:1",
            "SELKIES_TPU_SESSIONS_PER_CHIP": "2",
            "SELKIES_MESH_MAX_LANES": "1", "SELKIES_WATCHDOG_FRAMES": "0",
            "SELKIES_RESIZE_DEBOUNCE_MS": "20"}


async def _bucket_move(pkg, server):
    a, ta = await open_client(pkg, server, {
        "displayId": "d0", "initialClientWidth": 64,
        "initialClientHeight": 48, "framerate": 30})
    b, tb = await open_client(pkg, server, {
        "displayId": "d1", "initialClientWidth": 64,
        "initialClientHeight": 48, "framerate": 30})
    try:
        assert await wait_until(lambda: a.n_frames() >= 2
                                and b.n_frames() >= 2)
        old = server.mesh_coordinators[(64, 48, "jpeg")]
        mark = len(a.sent)
        a.feed("r,96x48,d0")
        assert await wait_until(lambda: (96, 48, "jpeg")
                                in server.mesh_coordinators)
        new = server.mesh_coordinators[(96, 48, "jpeg")]
        assert await wait_until(lambda: any(
            isinstance(m, bytes) for m in a.sent[a.sent.index(
                "PIPELINE_RESETTING d0", mark):]))
        n1 = b.n_frames()
        assert await wait_until(lambda: b.n_frames() > n1 + 2)
        reset = a.sent.index("PIPELINE_RESETTING d0", mark)
        first = [bytes(m) for m in a.sent[reset:] if isinstance(m, bytes)
                 and unpack_binary(bytes(m)).frame_id == 1]
        return {"texts": [t for t in a.sent[mark:reset + 1]
                          if isinstance(t, str) and not is_stats(t)],
                "buckets": sorted(server.mesh_coordinators),
                "sessions": (old.active_sessions, new.active_sessions),
                "mesh_stats": dict(server.mesh_stats),
                "b_resets": b.texts().count("PIPELINE_RESETTING d1"),
                "first": first}
    finally:
        await close_client(a, ta)
        await close_client(b, tb)


def fake_lane_server(pkg):
    """``pkg``'s server with device-free lanes: its own scheduler over its
    FakeMeshEncoder, two slots a lane."""
    from importlib import import_module

    server, _ = fake_server(pkg, **LANE_ENV)
    coord_mod = import_module(f"{pkg.ds.__package__.rsplit('.', 1)[0]}"
                              ".parallel.coordinator")

    def coordinator(spec, spc, w, h, **kw):
        kw.pop("slots_per_lane", None)
        return coord_mod.MeshEncodeCoordinator(
            spec, spc, w, h, enc_factory=pkg.rob.FakeMeshEncoder,
            slots_per_lane=2, lane_retire_s=0.2, **kw)

    server.coordinator_factory = coordinator
    return server


def test_lane_display_changes_bucket_equal_jax():
    """Device-free lanes: d0 resizes out of the shared 64x48 bucket into a
    96x48 one; d1 keeps its slot and streams without a reset."""
    async def scenario(pkg):
        server = fake_lane_server(pkg)
        try:
            return await _bucket_move(pkg, server)
        finally:
            await server.stop()

    jax = asyncio.run(scenario(JAX))
    port = asyncio.run(scenario(PORT))
    assert port == jax
    assert port["buckets"] == [(64, 48, "jpeg"), (96, 48, "jpeg")]
    assert port["sessions"] == (1, 1) and port["b_resets"] == 1
    assert port["mesh_stats"] == {"bucketed": 3, "solo_fallback": 0}


def test_drained_bucket_is_retired():
    """The port only: d0 resizes back into the 64x48 bucket, so the 96x48
    one has no session; once it has been idle for its lane_retire_s the
    stats loop's _retire_idle_buckets stops its scheduler and drops it
    (the JAX server keeps every bucket, and a scheduler its last lane)."""
    async def run():
        server = fake_lane_server(PORT)
        a, ta = await open_client(PORT, server, {
            "displayId": "d0", "initialClientWidth": 64,
            "initialClientHeight": 48, "framerate": 30})
        try:
            assert await wait_until(lambda: a.n_frames() >= 2)
            a.feed("r,96x48,d0")
            assert await wait_until(lambda: server.display_clients[
                "d0"].running_geom[:2] == (96, 48))
            await server._retire_idle_buckets()
            old = server.mesh_coordinators[(64, 48, "jpeg")]
            kept = dict(server.mesh_coordinators)   # idle, within grace
            await asyncio.sleep(0.3)
            await server._retire_idle_buckets()
            gone = sorted(server.mesh_coordinators)
            a.feed("r,64x48,d0")
            assert await wait_until(lambda: (64, 48, "jpeg")
                                    in server.mesh_coordinators
                                    and a.sent.count(
                                        "PIPELINE_RESETTING d0") == 3)
            n = a.n_frames()
            assert await wait_until(lambda: a.n_frames() > n + 2)
            return kept, gone, old
        finally:
            await close_client(a, ta)
            await server.stop()

    kept, gone, old = asyncio.run(run())
    # both buckets' schedulers were ticked by the server's one ticker
    assert {c._ticker for c in kept.values()} == {old._ticker}
    assert sorted(kept) == [(64, 48, "jpeg"), (96, 48, "jpeg")]
    assert gone == [(96, 48, "jpeg")] and old._thread is None


def test_one_ticker_thread_ticks_every_bucket():
    """The port only: schedulers handed one LaneTicker are ticked by its
    one thread, each at its own rate; stopping one leaves the other
    ticking, the last one out ends the thread, and a thread that died is
    replaced and counted in worker_restarts_total."""
    import threading
    import time

    from selkies_tpu_torch.parallel.coordinator import (LaneTicker,
                                                        MeshEncodeCoordinator)

    ticker = LaneTicker()
    seen = {}

    def coord(w):
        def factory(n):
            enc = trob.FakeMeshEncoder(n)
            dispatch = enc.dispatch

            def recording(frames):
                seen.setdefault(w, set()).add(threading.get_ident())
                return dispatch(frames)

            enc.dispatch = recording
            return enc
        return MeshEncodeCoordinator("session:1", 1, w, 48,
                                     enc_factory=factory, slots_per_lane=1,
                                     framerate=200.0, ticker=ticker)

    def pump(facades, secs):
        got = [0] * len(facades)
        end = time.monotonic() + secs
        while time.monotonic() < end:
            for k, f in enumerate(facades):
                f.try_submit(b"frame")
                got[k] += len(f.poll())
            time.sleep(0.005)
        return got

    a, b = coord(64), coord(96)
    fa, fb = a.acquire(64, 48), b.acquire(96, 48)
    try:
        assert a._thread is b._thread is ticker.thread
        assert all(n > 0 for n in pump([fa, fb], 0.3))
        assert seen[64] == seen[96] == {ticker.thread.ident}
        a.stop()
        assert a._thread is None and b._thread is ticker.thread
        assert pump([fb], 0.2)[0] > 0
        b.stop()
        assert ticker.thread is None
        b._ticker.thread = threading.Thread(target=lambda: None)
        b._ticker.thread.start()
        b._ticker.thread.join()                  # a worker that died
        fb2 = b.acquire(96, 48)
        assert b.worker_restarts_total == 1 and b._thread.is_alive()
        assert pump([fb2], 0.2)[0] > 0
    finally:
        a.stop()
        b.stop()
    assert ticker.thread is None


def test_lane_ticker_add_remove_stress():
    """More threads than cores add and remove schedulers on one ticker
    while it ticks (with a shortened switch interval): once remove
    returns, that scheduler is never ticked again, every scheduler still
    registered keeps being ticked, and the thread ends with the last."""
    import os
    import sys
    import threading
    import time

    from selkies_tpu_torch.parallel.coordinator import LaneTicker

    class Sched:
        framerate = 1000.0
        _next_tick = 0.0

        def __init__(self):
            self.removed = False
            self.late = 0
            self.ticks = 0

        def _stream_context(self):
            import contextlib
            return contextlib.nullcontext()

        def _tick_once(self, now):
            self.late += self.removed
            self.ticks += 1
            self._next_tick = now + 0.001

    ticker = LaneTicker()
    keep = Sched()
    ticker.add(keep)
    scheds, errors = [], []

    def churn(seed):
        try:
            for k in range(30):
                s = Sched()
                scheds.append(s)
                ticker.add(s)
                time.sleep(0.0005 * ((seed + k) % 3))
                ticker.remove(s)
                s.removed = True
        except Exception as e:              # pragma: no cover
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=churn, args=(i,))
                   for i in range(2 * (os.cpu_count() or 2) + 2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60.0)
        assert not any(t.is_alive() for t in threads)
        n = keep.ticks
        time.sleep(0.05)
        assert keep.ticks > n                   # still ticked
    finally:
        sys.setswitchinterval(old)
        ticker.remove(keep)
    assert not errors
    assert sum(s.late for s in scheds) == 0
    assert ticker.thread is None


def test_lane_display_changes_bucket_on_the_real_port_lanes():
    """The same move on the port's real JPEG lanes (MeshStripeEncoder,
    plain kernel on the CPU): the first frame in the new bucket equals a
    solo encoder's on the same source frame."""
    from selkies_tpu_torch.encoder.jpeg import JpegStripeEncoder
    from selkies_tpu_torch.protocol.wire import pack_jpeg_stripe

    class Static(FakeSource):
        def next_frame(self):
            return SyntheticSource(self.width, self.height, 30,
                                   pattern="desktop", seed=3).next_frame()

    async def scenario():
        server = PORT.server(dict(LANE_ENV, SELKIES_TPU_STRIPE_HEIGHT="16"),
                             source_factory=Static)
        try:
            return server.settings, await _bucket_move(PORT, server)
        finally:
            await server.stop()

    settings, res = asyncio.run(scenario())
    assert res["buckets"] == [(64, 48, "jpeg"), (96, 48, "jpeg")]
    assert res["sessions"] == (1, 1) and res["b_resets"] == 1
    solo = JpegStripeEncoder(96, 48, stripe_height=16,
                             quality=settings.jpeg_quality.default,
                             paintover_quality=settings
                             .paint_over_jpeg_quality.default, device="cpu")
    want = [pack_jpeg_stripe(1, s.y_start, s.jpeg)
            for s in solo.encode_frame(Static(96, 48, 30).next_frame())]
    assert res["first"] == want


# ---------------------------------------------------------------------------
# the ports of tests/test_server.py's tests, over a real websocket


async def serve(server):
    import websockets.asyncio.server as ws_server

    srv = await ws_server.serve(server.ws_handler, "127.0.0.1", 0,
                                compression=None, max_size=None)
    return srv, srv.sockets[0].getsockname()[1]


async def handshake(ws):
    assert await ws.recv() == "MODE websockets"
    assert json.loads(await ws.recv())["type"] == "server_settings"


def run_real(scenario, tmp_path, monkeypatch):
    """(JAX, port) results of ``scenario(pkg, port, root)`` served over a
    real websocket, each server with its own upload directory; each
    result carries the files left there."""
    out = []
    for pkg in (JAX, PORT):
        root = tmp_path / pkg.name / "uploads"
        monkeypatch.setenv("SELKIES_UPLOAD_DIR", str(root))

        async def run():
            server, built = fake_server(pkg, source=OneFrameSource,
                                        SELKIES_RESIZE_DEBOUNCE_MS="200")
            srv, port = await serve(server)
            try:
                return await scenario(pkg, server, built, port, root)
            finally:
                await server.stop()
                srv.close()
                await srv.wait_closed()

        res = asyncio.run(run())
        res["files"] = {os.path.relpath(os.path.join(d, f), root):
                        open(os.path.join(d, f), "rb").read()
                        for d, _, fs in os.walk(root) for f in fs}
        out.append(res)
    return out


async def texts_until(ws, pred, n=40):
    got = []
    for _ in range(n):
        m = await asyncio.wait_for(ws.recv(), 5)
        if isinstance(m, str) and not is_stats(m):
            got.append(m)
            if pred(m):
                break
    return got


def test_file_upload_and_path_traversal(tmp_path, monkeypatch):
    async def scenario(pkg, server, built, port, root):
        async with websockets.connect(f"ws://127.0.0.1:{port}") as ws:
            await handshake(ws)
            await ws.send("FILE_UPLOAD_START:sub/ok.txt:11")
            await ws.send(b"\x01hello")
            await ws.send(b"\x01 world")
            await ws.send("FILE_UPLOAD_END:sub/ok.txt")
            await ws.send("FILE_UPLOAD_START:../evil.txt:4")
            msg = await asyncio.wait_for(ws.recv(), 5)
            evil = (tmp_path / pkg.name / "evil.txt").exists()
            return {"reply": msg, "evil": evil}

    jax, port = run_real(scenario, tmp_path, monkeypatch)
    assert port == jax
    assert port["files"] == {"sub/ok.txt": b"hello world"}
    assert port["reply"] == "FILE_UPLOAD_ERROR:../evil.txt:invalid path"
    assert not port["evil"]


def test_upload_exceeding_declared_size_rejected(tmp_path, monkeypatch):
    async def scenario(pkg, server, built, port, root):
        async with websockets.connect(f"ws://127.0.0.1:{port}") as ws:
            await handshake(ws)
            await ws.send("FILE_UPLOAD_START:big.bin:4")
            await ws.send(b"\x01" + b"x" * 100)
            msg = await asyncio.wait_for(ws.recv(), 5)
            await ws.send(b"\x01more")
            await ws.send("r,bogus")
            await ws.send("CLIENT_FRAME_ACK notanint")
            pong = await ws.ping()
            await asyncio.wait_for(pong, 5)
            return {"reply": msg, "edge": dict(server.edge_stats)}

    jax, port = run_real(scenario, tmp_path, monkeypatch)
    assert port == jax
    assert port["reply"] == "FILE_UPLOAD_ERROR:big.bin:exceeded size limit"
    assert port["files"] == {}


def test_resize_resets_frame_ids(tmp_path, monkeypatch):
    async def scenario(pkg, server, built, port, root):
        async with websockets.connect(f"ws://127.0.0.1:{port}") as ws:
            await handshake(ws)
            await ws.send('SETTINGS,{"displayId": "primary"}')
            first = await texts_until(
                ws, lambda m: m.startswith("PIPELINE_RESETTING"))
            st = server.display_clients["primary"]
            st.bp.on_frame_sent(40000)
            st.bp.on_client_ack(40000)
            await ws.send("r,1280x720,primary")
            got = await texts_until(
                ws, lambda m: m.startswith("PIPELINE_RESETTING"))
            return {"first": first, "after_resize": got,
                    "last_sent_small": st.bp.last_sent_frame_id < 100,
                    "send_enabled": st.bp.send_enabled,
                    "width": st.width, "built": built}

    jax, port = run_real(scenario, tmp_path, monkeypatch)
    assert port == jax
    assert port["after_resize"][-1] == "PIPELINE_RESETTING primary"
    assert port["last_sent_small"] and port["send_enabled"]
    assert port["built"] == [(1024, 768), (1280, 720)]


class FakeXrandr:
    calls = []

    def __init__(self, *a, **k):
        pass

    def resize(self, w, h, refresh=60.0, output=None):
        self.calls.append(("resize", w, h))
        return f"{w}x{h}"

    def apply_layout(self, layout, refresh=60.0):
        self.calls.append(("layout", layout.fb_width, layout.fb_height,
                           tuple((p.display_id, p.x, p.y)
                                 for p in layout.placements)))


def _with_fake_xrandr(monkeypatch):
    for pkg in (JAX, PORT):
        monkeypatch.setattr(pkg.disp, "xrandr_available", lambda: True)
        monkeypatch.setattr(pkg.disp, "XrandrManager", FakeXrandr)


def test_multi_display_layout_drives_xrandr(tmp_path, monkeypatch):
    _with_fake_xrandr(monkeypatch)

    async def scenario(pkg, server, built, port, root):
        FakeXrandr.calls = []
        url = f"ws://127.0.0.1:{port}/"
        async with websockets.connect(url) as ws1:
            await handshake(ws1)
            await ws1.send("SETTINGS," + json.dumps(
                {"displayId": "primary", "initialClientWidth": 1920,
                 "initialClientHeight": 1080}))
            await asyncio.sleep(0.5)
            async with websockets.connect(url) as ws2:
                await handshake(ws2)
                await ws2.send("SETTINGS," + json.dumps(
                    {"displayId": "display2", "initialClientWidth": 1280,
                     "initialClientHeight": 720}))
                await asyncio.sleep(0.5)
                st2 = server.display_clients["display2"]
                offsets = ((st2.x, st2.y), st2.running_geom)
            await asyncio.sleep(0.6)
            return {"calls": list(FakeXrandr.calls), "offsets": offsets,
                    "displays": sorted(server.display_clients),
                    "built": list(built)}

    jax, port = run_real(scenario, tmp_path, monkeypatch)
    assert port == jax
    assert port["calls"] == [
        ("resize", 1920, 1080),
        ("layout", 3200, 1080, (("primary", 0, 0), ("display2", 1920, 0))),
        ("resize", 1920, 1080)]
    assert port["offsets"] == ((1920, 0), (1280, 720, 1920, 0))
    assert port["displays"] == ["primary"]
    # stop-the-world: every join and leave restarts every live display
    assert port["built"] == [(1920, 1080), (1920, 1080), (1280, 720),
                             (1920, 1080)]


def test_layout_dedup_skips_repeat_xrandr(tmp_path, monkeypatch):
    _with_fake_xrandr(monkeypatch)

    async def scenario(pkg, server, built, port, root):
        FakeXrandr.calls = []
        async with websockets.connect(f"ws://127.0.0.1:{port}/") as ws:
            await handshake(ws)
            body = "SETTINGS," + json.dumps(
                {"displayId": "primary", "initialClientWidth": 1024,
                 "initialClientHeight": 768})
            await ws.send(body)
            await asyncio.sleep(0.5)
            n_after = len(FakeXrandr.calls)
            await ws.send(body)
            await asyncio.sleep(0.5)
            n_repeat = len(FakeXrandr.calls)
            await ws.send("r,800x600")
            await asyncio.sleep(0.5)
            return {"n": (n_after, n_repeat), "calls": list(FakeXrandr.calls)}

    jax, port = run_real(scenario, tmp_path, monkeypatch)
    assert port == jax
    assert port["n"] == (1, 1)
    assert port["calls"] == [("resize", 1024, 768), ("resize", 800, 600)]

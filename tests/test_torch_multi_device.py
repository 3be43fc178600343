"""The port's lanes over several devices against the JAX package's sharded
lanes, on the CPU.

The JAX lanes run on the conftest's virtual CPU devices, sharded by
``shard_map`` over a ("session", "stripe") mesh; the port's run over a mesh
of as many ``torch.device("cpu")`` entries, one shard per entry, each
shard's step on its block of sessions and rows. The same numpy frames
from a seed go through both, tick by tick, and every byte must be equal
(tolerance: none):

* ``MeshStripeEncoder`` over ``session:2``, ``session:1,stripe:2`` and
  ``session:2,stripe:2``: each session's ``StripeOutput`` bytes and its
  coded bytes (the rate feedback, JAX's ``psum`` over "stripe", here a
  host sum of the shards' heads);
* ``MeshH264Encoder`` over ``session:2,stripe:2``: each session's Annex-B
  and coded bytes, with a small per-stripe CAVLC budget so noise stripes
  overflow and recover through the flat16 host coder on both; then
  split-frame encoding of one session (the others idle): the access unit
  concatenated from both stripe shards equals JAX's, and a stripe job
  that fails in the harvest withholds the whole access unit (never a torn
  one) and resyncs with a full IDR, on both. The JAX lane searches motion
  with its XLA chunked search (``me="xla"``), as ``tests/test_parallel.py``
  runs it on the CPU.

Then the scheduler's split-frame cases of ``tests/test_swarm.py`` on the
port (a fault on one shard of an SFE slot drops the whole frame and
migrates the session; the harvest trace splits fetch and concat), the
``system_health`` feed's ``sfe_*`` keys against the JAX server's on the
same fake lanes, a served SFE display of the real port lane, and mesh
specs that ask for more devices than there are.
"""

import asyncio
import functools
import json
import time

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax  # noqa: E402

from selkies_tpu.parallel import mesh as jmesh  # noqa: E402
from selkies_tpu.parallel import mesh_h264 as jmesh_h264  # noqa: E402
from selkies_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from selkies_tpu_torch.parallel import mesh_h264 as tmesh_h264  # noqa: E402

W, H, SH = 64, 64, 16
S = H // SH
CPU = torch.device("cpu")


def _meshes(spec):
    n = tmesh.parse_mesh_spec(spec, [CPU] * 8)
    count = n.shape["session"] * n.shape["stripe"]
    if len(jax.devices()) < count:
        pytest.skip(f"needs {count} virtual devices")
    return (jmesh.parse_mesh_spec(spec, jax.devices()[:count]),
            tmesh.parse_mesh_spec(spec, [CPU] * count))


def _content(seed, h=H, w=W):
    """Smooth gradients with one noisy block (seeded per session)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = np.stack([120 + 60 * np.sin(xx / 9.0 + seed) * np.cos(yy / 7.0),
                     110 + 60 * np.cos(xx / 11.0 - seed),
                     140 + 50 * np.sin(yy / 5.0 + seed)], -1)
    base[8:28, 10:40] = rng.integers(0, 256, (20, 30, 3))
    return np.clip(base, 0, 255).astype(np.uint8)


def _jpeg_of(out):
    return [[(s.y_start, s.height, s.is_paintover, s.jpeg) for s in sess]
            for sess in out]


def _h264_of(out):
    return [[(s.y_start, s.width, s.height, s.is_key, s.annexb)
             for s in sess] for sess in out]


# ---------------------------------------------------------------------------
# the JPEG lane


def _jpeg_ticks(n):
    """Per tick, n sessions' frames: noise (overflowed stripes at quality
    100), smooth content, an idle slot, one changed stripe, static ticks
    up to paint-over (trigger 2)."""
    rng = np.random.default_rng(5)
    noise = [rng.integers(0, 256, (H, W, 3), np.uint8) for _ in range(n)]
    smooth = [_content(10 + k) for k in range(n)]
    part = [f.copy() for f in smooth]
    part[-1][SH:2 * SH] = noise[-1][SH:2 * SH]
    return [noise, smooth, [None] + smooth[1:], part, part, part]


@pytest.mark.parametrize("spec", ["session:2", "session:1,stripe:2",
                                  "session:2,stripe:2"])
def test_mesh_stripe_encoder_matches_jax(spec):
    jm, tm = _meshes(spec)
    n = 2 * jm.shape["session"]
    kw = dict(stripe_h=SH, paint_over_trigger_frames=2, quality=100)
    jenc = jmesh.MeshStripeEncoder(jm, n, W, H, **kw)
    tenc = tmesh.MeshStripeEncoder(tm, n, W, H, **kw)
    assert tenc.n_shards == jm.shape["stripe"]
    for t, frames in enumerate(_jpeg_ticks(n)):
        if all(f is not None for f in frames):
            frames = np.stack(frames)
        jout, jbytes = jenc.encode_frames(frames)
        tout, tbytes = tenc.encode_frames(frames)
        assert _jpeg_of(tout) == _jpeg_of(jout), t
        assert list(tbytes) == list(jbytes), t
    assert tenc.host_fallback_stripes_total > 0
    st = tenc.last_harvest_stages
    assert len(st["per_shard_fetch_ms"]) == jm.shape["stripe"]


def test_batched_session_encoder_matches_jax():
    """The step without entropy coding over both axes: coefficients,
    damage and the rate feedback summed over the stripe axis onto the
    first device."""
    jm, tm = _meshes("session:2,stripe:2")
    rng = np.random.default_rng(7)
    frames = rng.integers(0, 256, (2, H, W, 3), dtype=np.uint8)
    qsel = np.zeros((2, S), np.int32)
    qsel[1, 2] = 1
    jenc = jmesh.BatchedSessionEncoder(jm, 2, W, H, stripe_h=SH)
    tenc = tmesh.BatchedSessionEncoder(tm, 2, W, H, stripe_h=SH)
    for step in range(2):
        want = jenc.step(frames, qsel)
        got = tenc.step(frames, qsel)
        for a, b in zip(got, want):
            assert np.array_equal(a.numpy(), np.asarray(b)), step


# ---------------------------------------------------------------------------
# the striped H.264 lane, and split-frame encoding of one session

#: a per-stripe CAVLC budget that smooth P stripes fit and noise stripes
#: pass: those take the overflow → flat16 fallback, per shard
SMALL_BUDGET = 160


@pytest.fixture(scope="module")
def h264_lanes():
    jm, tm = _meshes("session:2,stripe:2")
    kw = dict(stripe_h=SH, paint_over_trigger_frames=2, search=2)
    jenc = jmesh_h264.MeshH264Encoder(jm, 2, W, H, me="xla", **kw)
    tenc = tmesh_h264.MeshH264Encoder(tm, 2, W, H, **kw)
    # before the first (lazy) step build on both
    jenc._cavlc_msb = tenc._cavlc_msb = SMALL_BUDGET
    return jenc, tenc


def _h264_ticks():
    """The join IDR, motion, noise in one session (overflowed stripes),
    static, one changed stripe."""
    a, b = _content(20), _content(21)
    noise = np.random.default_rng(9).integers(0, 256, (H, W, 3), np.uint8)
    a2 = np.roll(a, 4, axis=0)
    a3 = a2.copy()
    a3[H // 2:H // 2 + SH] = _content(22)[:SH]
    return [[a, b], [a2, noise], [a2, np.roll(noise, 2, 1)], [a3, None],
            [a3, b]]


def test_mesh_h264_matches_jax(h264_lanes):
    jenc, tenc = h264_lanes
    assert tenc.n_shards == jenc.n_shards == 2
    fb0 = tenc.host_fallback_stripes_total
    for t, frames in enumerate(_h264_ticks()):
        jout, jbytes = jenc.encode_frames(frames)
        tout, tbytes = tenc.encode_frames(frames)
        assert _h264_of(tout) == _h264_of(jout), t
        assert list(tbytes) == list(jbytes), t
    # the overflow → flat16 fallback ran, on both, stripe for stripe
    assert tenc.host_fallback_stripes_total > fb0
    assert tenc.host_fallback_stripes_total == \
        jenc.host_fallback_stripes_total
    for name in ("_prev_y", "_prev_cb", "_prev_cr", "_ref_y", "_ref_cb",
                 "_ref_cr"):
        assert np.array_equal(tenc.gathered(name[1:]).numpy(),
                              np.asarray(getattr(jenc, name))), name


def test_sfe_concat_bit_exact_and_never_torn(h264_lanes, monkeypatch):
    """One session's frames split over the two stripe shards (the other
    session idle): each access unit, concatenated from both shards,
    equals JAX's, stripe by stripe, and the harvest attributes a fetch
    wall to each shard. Then a stripe job failing in the harvest withholds
    the whole access unit on both, the successor already in flight is
    withheld too, and the next tick resyncs with a full IDR — also after
    an idle tick."""
    jenc, tenc = h264_lanes
    base = _content(30)

    def both(frames):
        jo, jb = jenc.encode_frames(frames)
        to, tb = tenc.encode_frames(frames)
        assert _h264_of(to) == _h264_of(jo)
        assert list(tb) == list(jb)
        return to

    for t in range(4):
        out = both([np.roll(base, 4 * t, axis=0), None])
        assert b"".join(s.annexb for s in out[0])
    st = tenc.last_harvest_stages
    assert len(st["per_shard_fetch_ms"]) == 2 and st["concat_ms"] >= 0.0

    def fail_one_job(mod):
        """The first stripe job of the next harvest raises: a device-coded
        stripe's slice glue or a host-coded stripe's coder, whichever
        runs first."""
        fails = {"n": 0}

        def once(real):
            def fail_once(*a, **kw):
                if fails["n"] == 0:
                    fails["n"] += 1
                    raise RuntimeError("injected stripe entropy failure")
                return real(*a, **kw)
            return fail_once

        monkeypatch.setattr(mod.dcav, "assemble_p_slice",
                            once(mod.dcav.assemble_p_slice))
        monkeypatch.setattr(mod, "encode_picture_nals_np",
                            once(mod.encode_picture_nals_np))

    for mod in (jmesh_h264, tmesh_h264):
        fail_one_job(mod)
    pj = [jenc.dispatch([np.roll(base, 40, axis=0), None]),
          jenc.dispatch([np.roll(base, 44, axis=0), None])]
    pt = [tenc.dispatch([np.roll(base, 40, axis=0), None]),
          tenc.dispatch([np.roll(base, 44, axis=0), None])]
    for a, b in zip(pj, pt):
        jo, jb = jenc.harvest(a)
        to, tb = tenc.harvest(b)
        assert _h264_of(to) == _h264_of(jo) and to[0] == []   # withheld
        assert list(tb) == list(jb)
    assert tenc._need_idr[0].all()
    monkeypatch.undo()
    out = both([np.roll(base, 48, axis=0), None])
    assert len(out[0]) == S and all(s.is_key for s in out[0])

    # an idle tick of a withheld session still runs its full IDR resync
    for mod in (jmesh_h264, tmesh_h264):
        fail_one_job(mod)
    assert both([np.roll(base, 52, axis=0), None])[0] == []
    monkeypatch.undo()
    out = both([None, None])
    assert len(out[0]) == S and all(s.is_key for s in out[0])


# ---------------------------------------------------------------------------
# the scheduler's split-frame lanes (device-free FakeMeshEncoder lanes)


def _sfe_coord(n_shards=4, max_lanes=2, encs=None):
    from selkies_tpu_torch.parallel.coordinator import MeshEncodeCoordinator
    from selkies_tpu_torch.robustness import FakeMeshEncoder

    def factory(n):
        enc = FakeMeshEncoder(n, n_shards=n_shards)
        if encs is not None:
            encs.append(enc)
        return enc

    return MeshEncodeCoordinator(
        f"session:{n_shards}", 1, 3840, 2160, enc_factory=factory,
        slots_per_lane=1, max_lanes=max_lanes, framerate=200.0,
        health_sick_errors=3, health_window_s=30.0, lane_retire_s=5.0,
        sfe_shards=n_shards)


def test_sfe_shard_fault_contains_whole_frame_and_migrates():
    """A ``mesh.slot_raise`` aimed at ONE stripe shard of an SFE session
    degrades that session: every delivered frame carries all its shards'
    stripes (never a torn access unit), repeats quarantine the slot and
    migrate the session, and the neighbouring SFE lane keeps streaming."""
    from selkies_tpu_torch.robustness import FaultInjector

    coord = _sfe_coord(n_shards=4, max_lanes=3)
    coord.faults = FaultInjector()
    try:
        victim = coord.acquire(3840, 2160)
        cohab = coord.acquire(3840, 2160)
        cap = coord.capacity()
        assert cap["sfe_shards"] == 4 and cap["chips_per_slot"] == 4
        lane0, slot0 = victim.lane_id, victim.slot
        coord.faults.arm("mesh.slot_raise", times=4,
                         arg=f"{lane0}:{slot0}:2")
        got = {0: [], 1: []}
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline and coord.migrations_total < 1:
            for i, f in enumerate((victim, cohab)):
                f.try_submit(b"frame")
                got[i] += f.poll()
            time.sleep(0.005)
        st = coord.stats()
        assert st["migrations_total"] == 1
        assert st["quarantined_total"] == 1
        assert st["slot_faults_total"] >= 3
        assert victim.lane_id != lane0
        assert victim.consume_migration() is True
        assert len(got[1]) > 0
        for i in got:
            for _seq, stripes in got[i]:
                assert len(stripes) == 4, "torn SFE access unit"
        deadline = time.monotonic() + 1.0
        n0 = len(got[0])
        while time.monotonic() < deadline and len(got[0]) == n0:
            victim.try_submit(b"frame")
            got[0] += victim.poll()
            time.sleep(0.005)
        assert len(got[0]) > n0
        assert coord.verify_slot_accounting() == []
    finally:
        coord.stop()


def test_sfe_harvest_trace_splits_fetch_and_pack():
    """The scheduler folds the lane's ``last_harvest_stages`` into the
    frame trace (fetch_wait, then pack, contiguous), and ``stats()``
    carries ``sfe_shards`` and the fetch and concat p50s."""
    coord = _sfe_coord(n_shards=2, max_lanes=1)
    try:
        f = coord.acquire(3840, 2160)
        tr = None
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline and tr is None:
            f.try_submit(b"frame")
            for seq, _stripes in f.poll():
                tr = f.pop_trace(seq)
            time.sleep(0.005)
        assert tr is not None
        fw0, fw1 = tr["fetch_wait"]
        pk0, pk1 = tr["pack"]
        assert "dispatch" in tr and fw1 == pk0 and fw0 <= fw1 <= pk1
        st = coord.stats()
        assert st["sfe_shards"] == 2
        assert st["sfe_concat_ms_p50"] > 0.0
        assert st["sfe_fetch_ms_p50"] > 0.0
    finally:
        coord.stop()


def test_sfe_lanes_from_the_default_factory():
    """The default factory repartitions a session axis stripe-major for a
    geometry of at least ``sfe_min_pixels`` (one session's bands over both
    devices: a slot costs 2), builds real port lanes over it, and a spec
    that asks for more devices than there are raises, as in the JAX
    package."""
    from selkies_tpu_torch.parallel.coordinator import MeshEncodeCoordinator
    from selkies_tpu_torch.settings import Settings

    for min_pixels, shards, slots in ((0, 1, 2), (W * H, 2, 1)):
        settings = Settings(argv=[], env={
            "SELKIES_SFE_MIN_PIXELS": str(min_pixels),
            "SELKIES_TPU_STRIPE_HEIGHT": str(SH)})
        for profile in ("jpeg", "x264enc-striped"):
            coord = MeshEncodeCoordinator(
                "session:2", 1, W, H, settings=settings, profile=profile,
                device="cpu", devices=[CPU, CPU])
            try:
                assert coord.sfe_shards == shards
                assert coord.slots_per_lane == slots
                assert coord.capacity()["chips_per_slot"] == shards
                assert coord.lanes[0].enc.n_shards == shards
            finally:
                coord.stop()
    with pytest.raises(ValueError, match="needs 2 devices; 1 available"):
        MeshEncodeCoordinator("session:1,stripe:2", 1, W, H, device="cpu")


# ---------------------------------------------------------------------------
# the serving plane: the health feed, and a served SFE display


class _Source:
    def __init__(self, width, height, fps):
        self.width, self.height = width, height

    def start(self):
        pass

    def stop(self):
        pass

    def next_frame(self):
        return _content(3, self.height, self.width)


def _sfe_env():
    return {"SELKIES_PORT": "0", "SELKIES_AUDIO_ENABLED": "false",
            "SELKIES_SECOND_SCREEN": "true", "SELKIES_MAX_DISPLAYS": "0",
            "SELKIES_TPU_MESH": "session:2",
            "SELKIES_SFE_MIN_PIXELS": "1",
            "SELKIES_TPU_SESSIONS_PER_CHIP": "1",
            "SELKIES_TPU_STRIPE_HEIGHT": str(SH),
            "SELKIES_WATCHDOG_FRAMES": "0"}


async def _open(server, rob, did):
    ws = rob.InProcessClient()
    task = asyncio.create_task(server.ws_handler(ws))
    ws.feed("SETTINGS," + json.dumps({
        "displayId": did, "initialClientWidth": W,
        "initialClientHeight": H, "framerate": 30}))
    return ws, task


async def _until(pred, timeout):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline and not pred():
        await asyncio.sleep(0.01)
    return pred()


def _fake_sfe_server(pkg):
    """The JAX or the port server, its lanes the real scheduler over
    two-shard ``FakeMeshEncoder`` lanes (SFE slots of 2 devices)."""
    if pkg == "jax":
        from selkies_tpu import robustness as rob
        from selkies_tpu.parallel.coordinator import MeshEncodeCoordinator
        from selkies_tpu.server.data_server import DataStreamingServer
        from selkies_tpu.settings import Settings
        extra = {}
    else:
        from selkies_tpu_torch import robustness as rob
        from selkies_tpu_torch.parallel.coordinator import \
            MeshEncodeCoordinator
        from selkies_tpu_torch.server.data_server import DataStreamingServer
        from selkies_tpu_torch.settings import Settings
        extra = {"device": "cpu"}

    class _Solo:
        def try_submit(self, frame):
            return None

        def poll(self):
            return []

        def force_keyframe(self):
            pass

        def close(self):
            pass

    server = DataStreamingServer(
        Settings(argv=[], env=_sfe_env()),
        encoder_factory=lambda w, h, s, overrides=None, **kw: _Solo(),
        source_factory=_Source, host="127.0.0.1", **extra)

    def coordinator(spec, spc, w, h, **kw):
        for k in ("device", "ticker", "devices", "slots_per_lane"):
            kw.pop(k, None)
        return MeshEncodeCoordinator(
            spec, spc, w, h, slots_per_lane=1, lane_retire_s=0.2,
            enc_factory=lambda n: rob.FakeMeshEncoder(n, n_shards=2),
            sfe_shards=2, **kw)

    server.coordinator_factory = coordinator
    return server, rob


def _health_mesh(pkg):
    async def run():
        server, rob = _fake_sfe_server(pkg)
        try:
            ws, task = await _open(server, rob, "d0")
            coord = None

            def ready():
                nonlocal coord
                coord = next(iter(server.mesh_coordinators.values()), None)
                return coord is not None and \
                    coord.stats()["sfe_concat_ms_p50"] > 0
            assert await _until(ready, 10.0)
            entry = json.loads(server._health_payload())["mesh"]
            cap = coord.capacity()
            await ws.close()
            await asyncio.wait_for(task, 5.0)
            return entry, cap
        finally:
            await server.stop()
    return asyncio.run(run())


def test_system_health_sfe_keys_equal_jax():
    jmesh_entry, jcap = _health_mesh("jax")
    tmesh_entry, tcap = _health_mesh("torch")
    assert list(tmesh_entry) == list(jmesh_entry) == [f"{W}x{H}/jpeg"]
    (je,), (te,) = jmesh_entry.values(), tmesh_entry.values()
    assert sorted(te) == sorted(je)
    assert te["sfe_shards"] == je["sfe_shards"] == 2
    assert te["sfe_concat_ms_p50"] > 0 and je["sfe_concat_ms_p50"] > 0
    assert {k: tcap[k] for k in ("sfe_shards", "chips_per_slot")} == \
        {k: jcap[k] for k in ("sfe_shards", "chips_per_slot")} == \
        {"sfe_shards": 2, "chips_per_slot": 2}


def test_served_sfe_display_equals_solo():
    """A JPEG display served through ``ws_handler`` from an SFE lane of
    the real port ``MeshStripeEncoder`` over two CPU devices: its first
    frame's 0x03 stripes equal a solo ``JpegStripeEncoder``'s, and the
    health feed and the stats feed report two shards."""
    from selkies_tpu_torch import robustness as rob
    from selkies_tpu_torch.encoder.jpeg import JpegStripeEncoder
    from selkies_tpu_torch.parallel.coordinator import MeshEncodeCoordinator
    from selkies_tpu_torch.protocol.wire import (pack_jpeg_stripe,
                                                 unpack_binary)
    from selkies_tpu_torch.server import data_server as tds
    from selkies_tpu_torch.settings import Settings

    async def run():
        settings = Settings(argv=[], env=_sfe_env())
        server = tds.DataStreamingServer(
            settings, source_factory=_Source, device="cpu",
            host="127.0.0.1")
        server.coordinator_factory = functools.partial(
            MeshEncodeCoordinator, devices=[CPU, CPU])
        interval, tds.STATS_INTERVAL_S = tds.STATS_INTERVAL_S, 0.2
        try:
            ws, task = await _open(server, rob, "d0")
            assert await _until(lambda: len(ws.binary()) >= S, 30.0)
            coord = server.mesh_coordinators[(W, H, "jpeg")]
            assert coord.capacity()["chips_per_slot"] == 2
            assert await _until(
                lambda: any('"mesh_sfe_shards": 2' in t
                            for t in ws.texts()), 10.0)
            mesh = json.loads(server._health_payload())["mesh"]
            assert mesh[f"{W}x{H}/jpeg"]["sfe_shards"] == 2
            solo = JpegStripeEncoder(
                W, H, stripe_height=SH,
                quality=settings.jpeg_quality.default,
                paintover_quality=settings.paint_over_jpeg_quality.default,
                device="cpu")
            want = [pack_jpeg_stripe(1, s.y_start, s.jpeg)
                    for s in solo.encode_frame(_content(3))]
            first = [m for m in ws.binary() if unpack_binary(m).frame_id == 1]
            assert first == want
            await ws.close()
            await asyncio.wait_for(task, 5.0)
        finally:
            tds.STATS_INTERVAL_S = interval
            await server.stop()
    asyncio.run(run())


@pytest.mark.parametrize("spec", ["session:2", "session:1,stripe:2",
                                  "session:2,stripe:2"])
def test_mesh_spec_past_the_devices_raises_as_jax(spec):
    """A spec that asks for more devices than the list holds raises the
    JAX package's error; nothing folds onto fewer devices."""
    n = 1 if spec != "session:2,stripe:2" else 3

    def run(parse, devices):
        with pytest.raises(ValueError) as e:
            parse(spec, devices)
        return str(e.value)

    assert run(tmesh.parse_mesh_spec, [CPU] * n) == \
        run(jmesh.parse_mesh_spec, jax.devices()[:n])

"""Batched H.264 dispatch of the port against the JAX package on the CPU.

B frames per device step (``H264StripeEncoder.dispatch_batch``, through
``PipelinedH264Encoder(batch=B)``): the same frames in, the same Annex-B
bytes out (tolerance 0) as the JAX package's batched pipeline, as its
sequential encoder, and as the port's own one-frame-per-dispatch
pipeline, for B = 3 and 4, both entropy tiers and both H.264 profiles, at
128x96 (stripe height 32, or one full-frame stripe). The sequence, in
batches of B (each batch harvested before the next is dispatched): an IDR
batch (while a stripe needs an IDR the frames go through the one-frame
step), two moving frames and then static ones, an all-static batch in
which the stripes cross the paint-over trigger (B frames) at its third
frame, a keyframe request, two batches of motion, and a partial batch that
``flush`` drains. With the trigger at B a batch's per-frame paint forecast
is exact, so the batched and sequential bytes are the same ones.

Also: the undershoot of a small pinned batch prefix (every emitting stripe
re-read from its exact levels), the IDR path avoiding the batched step,
the batch deadline (re-armed by every submit) on a set clock, a failed
batch counting its other frames as drops, and the data server's factory
with ``SELKIES_TPU_ASYNC_BATCH``.

The JAX encoders search motion through the package's plain reference of
its Pallas kernel (``SELKIES_TPU_ME=scan``), as tests/test_torch_h264.py
does; each JAX reference runs once per module (module-scoped fixture)."""

import asyncio
import functools
import json

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from selkies_tpu.encoder.h264 import H264StripeEncoder as JaxEncoder  # noqa: E402
from selkies_tpu.encoder.pipeline import PipelinedH264Encoder as JaxPipeline  # noqa: E402
from selkies_tpu_torch.encoder import h264_device as tdev  # noqa: E402
from selkies_tpu_torch.encoder import pipeline as tpipe  # noqa: E402
from selkies_tpu_torch.encoder.h264 import H264StripeEncoder  # noqa: E402
from selkies_tpu_torch.encoder.pipeline import PipelinedH264Encoder  # noqa: E402
from selkies_tpu_torch.robustness import InProcessClient  # noqa: E402

W, H = 128, 96
PROFILES = {"striped": dict(stripe_height=32), "fullframe": dict(fullframe=True)}
CONFIGS = [(p, e, b) for p in PROFILES for e in ("device", "host")
           for b in (3, 4)]


def _base(seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    base = np.stack([120 + 60 * np.sin(xx / 9.0) * np.cos(yy / 7.0),
                     110 + 60 * np.cos(xx / 11.0),
                     140 + 50 * np.sin(yy / 5.0)], -1)
    base[20:50, 30:90] = rng.integers(0, 256, (30, 60, 3))
    return np.clip(base, 0, 255).astype(np.uint8)


def _frames(B):
    """Batches of B: IDR batch; two moving frames, then static; all
    static (paint-over at its third frame); [keyframe request] motion;
    motion; then B - 1 moving frames (a partial batch)."""
    base = _base()
    moving = [np.roll(base, 3 * k, axis=0) for k in range(B + 2)]
    still = [moving[-1]] * (2 * B - 2)
    later = [np.roll(base, 3 * k + 40, axis=0) for k in range(3 * B - 1)]
    return moving + still + later


def _keyframe_at(B):
    return 3 * B


def _paint_frame(B):
    return 2 * B + 2


def _stripes(out):
    return [(s.y_start, s.width, s.height, s.is_key, s.annexb) for s in out]


@pytest.fixture(scope="module", autouse=True)
def _plain_reference_search():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SELKIES_TPU_ME", "scan")
        yield


def _jax_encoder(profile, entropy, B):
    enc = JaxEncoder(W, H, entropy=entropy, paint_over_trigger_frames=B,
                     **PROFILES[profile])
    # the fetch-prefix tier sets how many bytes are read, never the bytes
    # coded; one tier keeps the reference to one compiled program per shape
    enc._prefix_small = enc._batch_prefix
    return enc


def _port_encoder(profile, entropy, B):
    return H264StripeEncoder(W, H, entropy=entropy, device="cpu",
                             paint_over_trigger_frames=B,
                             **PROFILES[profile])


def _drive(pipe, frames, B, mode, stack, step=None):
    """Submit ``frames`` of the B sequence in batches of ``step`` (default
    B; ``submit`` frame by frame, or ``submit_batch`` of a stacked batch;
    a short tail always frame by frame), harvesting every batch before the
    next; the keyframe request lands between batches. Returns every
    frame's stripes in order."""
    got = {}
    step = step or B
    for i in range(0, len(frames), step):
        if i == _keyframe_at(B):
            pipe.request_keyframe()
        chunk = frames[i:i + step]
        if mode == "submit_batch" and len(chunk) == step:
            pipe.submit_batch(stack(chunk))
        else:
            for f in chunk:
                pipe.submit(f)
        got.update(pipe.flush())
    assert sorted(got) == list(range(len(frames)))
    return [_stripes(got[k]) for k in range(len(frames))]


@pytest.fixture(scope="module")
def jax_runs():
    """{(profile, entropy, B): (sequential, batched)} of the JAX package."""
    out = {}
    for profile, entropy, B in CONFIGS:
        frames = _frames(B)
        enc = _jax_encoder(profile, entropy, B)
        seq = []
        for k, f in enumerate(frames):
            if k == _keyframe_at(B):
                enc.request_keyframe()
            seq.append(_stripes(enc.encode_frame(f)))
        pipe = JaxPipeline(_jax_encoder(profile, entropy, B), depth=4 * B,
                           batch=B)
        batched = _drive(pipe, frames, B, "submit_batch",
                         lambda c: jnp.asarray(np.stack(c)))
        out[profile, entropy, B] = seq, batched
    return out


@pytest.fixture(scope="module")
def port_solo():
    """{(profile, entropy, B): the port's batch=1 pipeline's stripes}."""
    return {cfg: _drive(PipelinedH264Encoder(_port_encoder(*cfg), depth=4),
                        _frames(cfg[2]), cfg[2], "submit", None, step=1)
            for cfg in CONFIGS}


@pytest.mark.parametrize("mode", ["submit", "submit_batch"])
@pytest.mark.parametrize("profile,entropy,B", CONFIGS)
def test_batched_annexb_equals_jax_and_one_frame_dispatch(
        jax_runs, port_solo, profile, entropy, B, mode):
    frames = _frames(B)
    pipe = PipelinedH264Encoder(_port_encoder(profile, entropy, B),
                                depth=4 * B, batch=B)
    got = _drive(pipe, frames, B, mode, np.stack)
    seq, batched = jax_runs[profile, entropy, B]
    assert seq == batched            # the reference agrees with itself
    for k in range(len(frames)):
        assert got[k] == batched[k], f"frame {k}"
    assert got == port_solo[profile, entropy, B]
    st = pipe.stats()
    assert st["frames"] == len(frames) and st["entropy_errors"] == 0
    assert st["batch"] == B and st["frames_dropped"] == 0
    assert pipe._staging_batch.in_use == 0 and pipe._staging.in_use == 0


@pytest.mark.parametrize("profile,entropy,B", CONFIGS)
def test_sequence_covers_idr_paint_over_mid_batch_and_partial(
        port_solo, profile, entropy, B, monkeypatch):
    """The sequence really holds what the byte test claims: IDRs at 0 and
    at the keyframe request, a paint-over of every stripe at the third
    frame of a static batch and nothing after it, motion in every P batch;
    and the batched steps really ran (whole batches only)."""
    seq = port_solo[profile, entropy, B]
    n_stripes = 3 if profile == "striped" else 1
    for k in (0, _keyframe_at(B)):
        assert len(seq[k]) == n_stripes and all(s[3] for s in seq[k])
    paint = _paint_frame(B)
    assert len(seq[paint]) == n_stripes and not any(s[3] for s in seq[paint])
    assert all(seq[k] == [] for k in range(B + 2, paint))
    assert all(seq[k] == [] for k in range(paint + 1, 3 * B))

    name = ("encode_frame_p_batch_rgb" if entropy == "host"
            else "encode_frame_p_batch_cavlc_rgb")
    sizes = []
    real = getattr(tdev, name)

    def spy(rgbs, *a, **kw):
        sizes.append(int(rgbs.shape[0]))
        return real(rgbs, *a, **kw)

    monkeypatch.setattr(tdev, name, spy)
    pipe = PipelinedH264Encoder(_port_encoder(profile, entropy, B),
                                depth=4 * B, batch=B)
    _drive(pipe, _frames(B), B, "submit", None)
    # batch 0 and the keyframe batch go frame by frame; the tail is partial
    assert sizes == [B] * 3


@pytest.mark.parametrize("profile,entropy", [(p, e) for p in PROFILES
                                             for e in ("device", "host")])
def test_packing_a_batch_in_chunks_changes_no_byte(
        port_solo, profile, entropy, monkeypatch):
    """B = 4 packed three frames per packer call (a chunk of 3 and one of
    1): the bytes stay the one-frame-per-dispatch pipeline's."""
    B = 4
    monkeypatch.setattr(tdev, "PACK_FRAMES", 3)
    spans = []
    real = tdev._chunked_heads

    def spy(pack, n, prefix):
        def counted(lo, hi):
            spans.append((lo, hi))
            return pack(lo, hi)
        return real(counted, n, prefix)

    monkeypatch.setattr(tdev, "_chunked_heads", spy)
    pipe = PipelinedH264Encoder(_port_encoder(profile, entropy, B),
                                depth=4 * B, batch=B)
    got = _drive(pipe, _frames(B), B, "submit_batch", np.stack)
    assert spans == [(0, 3), (3, 4)] * 3
    assert got == port_solo[profile, entropy, B]


@pytest.mark.parametrize("profile,entropy", [(p, e) for p in PROFILES
                                             for e in ("device", "host")])
def test_batch_undershoot_recovers_exactly(jax_runs, profile, entropy):
    """A pinned batch prefix too small for the frames' bytes: a batched
    frame keeps no full buffer, so every emitting stripe is coded from
    its exact levels (read at once for the whole frame when more than two
    stripes need them), the large prefix grows, and the bytes stay the
    sequential JAX encoder's."""
    B = 3
    enc = _port_encoder(profile, entropy, B)
    # below every frame's bytes: the head and 64 bytes of payload
    enc._prefix_large = enc._prefix_small = small = enc._fixed_bytes + 64
    pipe = PipelinedH264Encoder(enc, depth=4 * B, batch=B)
    got = _drive(pipe, _frames(B), B, "submit_batch", np.stack)
    seq, _ = jax_runs[profile, entropy, B]
    for k in range(len(got)):
        assert got[k] == seq[k], f"frame {k}"
    assert enc.host_coded_stripes_total > 0
    assert enc.d2h_refetch_bytes_total > 0
    assert enc._prefix_large > small
    assert enc.entropy_errors_total == 0


def test_more_than_two_overflowed_rows_read_the_whole_frame(monkeypatch):
    """Three overflowed stripes: one read of the frame's exact levels,
    not a gather of the rows."""
    enc = _port_encoder("striped", "device", 3)
    enc._prefix_large = enc._prefix_small = enc._fixed_bytes + 64
    frames = _frames(3)
    pipe = PipelinedH264Encoder(enc, depth=12, batch=3)
    pipe.submit_batch(np.stack(frames[:3]))
    pipe.flush()
    reads = []
    real = enc._to_host

    def to_host(t):
        reads.append(tuple(t.shape))
        return real(t)

    monkeypatch.setattr(enc, "_to_host", to_host)
    pipe.submit_batch(np.stack(frames[3:6]))
    pipe.flush()
    assert (enc.n_stripes, enc._stripe_words) in reads


def test_idr_recovery_avoids_the_batched_step(monkeypatch):
    """While any stripe needs an IDR, dispatch_batch rides the one-frame
    step; in steady state one batched step runs per batch."""
    calls = []
    real = tdev.encode_frame_p_batch_cavlc_rgb

    def spy(rgbs, *a, **kw):
        calls.append(int(rgbs.shape[0]))
        return real(rgbs, *a, **kw)

    monkeypatch.setattr(tdev, "encode_frame_p_batch_cavlc_rgb", spy)
    enc = _port_encoder("striped", "device", 15)
    rgbs = np.stack(_frames(4)[:4])
    pends = enc.dispatch_batch(rgbs)               # first call: IDR path
    assert calls == [] and pends[0].is_idr
    assert not any(p.is_idr for p in pends[1:])
    for p in pends:
        enc.harvest(p)
    pends = enc.dispatch_batch(rgbs)
    assert calls == [4]
    assert all(p.batch_heads is pends[0].batch_heads for p in pends)
    assert [p.batch_index for p in pends] == [0, 1, 2, 3]
    for p in pends:
        enc.harvest(p)
    # one host copy of the heads, read once, shared by the batch
    assert pends[0].batch_cache["host"].shape[0] == 4


def test_flush_drains_a_partial_batch(port_solo):
    """With no poll, the deadline never fires: flush() alone dispatches
    and drains the held frames."""
    B = 3
    frames = _frames(B)[:5]
    pipe = PipelinedH264Encoder(_port_encoder("striped", "device", B),
                                depth=12, batch=B)
    for f in frames:
        pipe.submit(f)        # one whole batch dispatches; 2 are held
    assert pipe.n_held == 2
    got = dict(pipe.flush())
    assert sorted(got) == list(range(5))
    assert pipe.n_held == 0 and pipe.n_inflight == 0
    want = port_solo["striped", "device", B]
    assert [_stripes(got[k]) for k in range(5)] == want[:5]


class _Clock:
    """Stands in for the pipeline's deadline clock."""

    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def _counting_pipeline(monkeypatch):
    """A batch-3 pipeline on a set clock, counting its one-frame and
    batched device steps; its deadline is the computed default."""
    clock = _Clock()
    monkeypatch.setattr(tpipe, "_now", clock)
    enc = _port_encoder("striped", "device", 15)
    calls = {"solo": 0, "batch": 0}
    real_d, real_db = enc._dispatch, enc._dispatch_batch

    def d(frame, fetch):
        calls["solo"] += 1
        return real_d(frame, fetch)

    def db(rgbs, fetch):
        calls["batch"] += 1
        return real_db(rgbs, fetch)

    enc._dispatch, enc._dispatch_batch = d, db
    pipe = PipelinedH264Encoder(enc, depth=12, batch=3)
    frames = [np.roll(_base(), 2 * k, axis=0) for k in range(30)]
    for f in frames[:4]:                     # warm: the IDR batch
        pipe.submit(f)
    pipe.flush()
    calls["solo"] = calls["batch"] = 0
    return pipe, calls, clock, iter(frames[4:])


def test_deadline_rearms_on_every_submit(monkeypatch):
    """A stream ticking slower than deadline/batch still forms whole
    batches (the deadline detects a pause, not a slow caller); a pause
    ships the partial batch frame by frame; the resumed stream batches
    again at once."""
    pipe, calls, clock, frames = _counting_pipeline(monkeypatch)
    gap = 0.8 * pipe.batch_deadline_s
    for _ in range(9):
        pipe.submit(next(frames))
        clock.t += gap                      # under the deadline: live
        pipe.poll(flush_partial=False)
    pipe.flush()
    assert calls == {"solo": 0, "batch": 3}

    calls["solo"] = calls["batch"] = 0
    pipe.submit(next(frames))
    clock.t += gap
    assert pipe.poll(flush_partial=False) == [] and calls["solo"] == 0
    clock.t += gap                          # past the deadline
    pipe.poll(flush_partial=False)
    assert calls == {"solo": 1, "batch": 0}
    pipe.flush()

    calls["solo"] = calls["batch"] = 0
    for _ in range(6):
        pipe.submit(next(frames))
        pipe.poll(flush_partial=False)
    pipe.flush()
    assert calls == {"solo": 0, "batch": 2}


def test_staleness_is_bounded_by_batch_deadlines(monkeypatch):
    """Submits just under the deadline apart: the first batch ships whole
    once its third frame arrives, within batch x deadline of its first."""
    pipe, calls, clock, frames = _counting_pipeline(monkeypatch)
    deadline = pipe.batch_deadline_s
    t0 = clock.t
    shipped_at = None
    for _ in range(12):
        pipe.submit(next(frames))
        if calls["batch"]:
            shipped_at = clock.t - t0
            break
        clock.t += 0.9 * deadline
        pipe.poll(flush_partial=False)
    assert calls == {"solo": 0, "batch": 1}
    assert shipped_at is not None and shipped_at <= 3 * deadline
    assert len(pipe.flush()) == 3


def test_a_failed_batch_counts_its_other_frames_as_drops(monkeypatch):
    """One exception reaches the caller; the batch's other B-1 frames are
    drops; the batch ring's slot is freed; the pipeline goes on."""
    pipe, calls, clock, frames = _counting_pipeline(monkeypatch)

    def boom(rgbs, fetch):
        raise RuntimeError("injected dispatch failure")

    real = pipe.base._dispatch_batch
    pipe.base._dispatch_batch = boom
    pipe.submit(next(frames))
    pipe.submit(next(frames))
    with pytest.raises(RuntimeError):
        pipe.submit(next(frames))
    assert pipe.stats()["frames_dropped"] == 2
    assert pipe._staging_batch.in_use == 0 and pipe.n_held == 0
    pipe.base._dispatch_batch = real
    pipe.submit_batch(np.stack([next(frames) for _ in range(3)]))
    assert len(pipe.flush()) == 3


def test_try_submit_drops_instead_of_draining_for_a_held_frame():
    """In-flight and held frames together fill the pipeline: try_submit
    drops the frame rather than harvesting one (which would block); a
    depth below the batch, where no batch could fill, is refused."""
    pipe = PipelinedH264Encoder(_port_encoder("striped", "device", 3),
                                depth=4, batch=3)
    frames = _frames(3)
    for f in frames[:3]:
        assert pipe.try_submit(f) is not None    # one whole batch
    assert pipe.try_submit(frames[3]) is not None
    assert (pipe.n_inflight, pipe.n_held) == (3, 1)
    assert pipe.try_submit(frames[4]) is None
    assert pipe.frames_completed == 0 and pipe.n_held == 1
    assert pipe.stats()["frames_dropped"] == 1
    assert len(pipe.flush()) == 4
    with pytest.raises(ValueError):
        PipelinedH264Encoder(_port_encoder("striped", "device", 3),
                             depth=2, batch=3)


def test_the_batch_slot_frees_after_its_last_frame():
    """One staged buffer backs every frame of a batch: its ring slot stays
    busy until the last of them is harvested."""
    B = 3
    pipe = PipelinedH264Encoder(_port_encoder("striped", "host", B),
                                depth=12, batch=B)
    frames = _frames(B)
    pipe.submit_batch(np.stack(frames[:B]))      # the IDR batch
    pipe.flush()
    pipe.submit_batch(np.stack(frames[B:2 * B]))
    for k in range(B):
        assert pipe._staging_batch.in_use == 1
        item = pipe._inflight.popleft()
        assert pipe._advance(item, block=True)
        pipe._complete(item)
    assert pipe._staging_batch.in_use == 0 and not pipe._inflight


# ---------------------------------------------------------------------------
# the data server's factory


def _settings(profile):
    from selkies_tpu_torch.settings import Settings

    return Settings(argv=[], env={"SELKIES_PORT": "0",
                                  "SELKIES_AUDIO_ENABLED": "false",
                                  "SELKIES_ENCODER": profile,
                                  "SELKIES_TPU_STRIPE_HEIGHT": "32"})


@pytest.mark.parametrize("profile", ["x264enc-striped", "x264enc"])
def test_factory_reads_selkies_tpu_async_batch(monkeypatch, profile):
    from selkies_tpu_torch.server.data_server import default_encoder_factory

    monkeypatch.setenv("SELKIES_TPU_ASYNC_BATCH", "3")
    drv = default_encoder_factory(W, H, _settings(profile), device="cpu")
    try:
        assert type(drv).__name__ == "AsyncEncodeDriver"
        assert drv.pipe.batch == 3 and drv.pipe.depth == 9
        assert drv.pipe.fetch_group == 2
        assert drv.flush_partial_when_idle is False
        assert drv.wire_fullframe == (profile == "x264enc")
    finally:
        drv.close()
        assert drv.join(30.0)
    monkeypatch.setenv("SELKIES_TPU_ASYNC_BATCH", "1")
    drv = default_encoder_factory(W, H, _settings(profile), device="cpu")
    try:
        assert drv.pipe.batch == 1 and drv.pipe.depth == 4
        assert drv.flush_partial_when_idle is True
    finally:
        drv.close()
        assert drv.join(30.0)


N_SERVED = 7


class _FiniteSource:
    """The first N_SERVED frames of a moving sequence, then nothing (a
    source that runs dry, so both servers encode the same frames).

    The capture loop drops a frame at the edge when the display's async
    driver has no room in its submit queue (``try_submit`` returns None),
    as it must for a live desktop. A first-use build of the host coder
    stalls the driver for seconds, and this source's frames are finite, so
    it hands out its next frame only while the queue has room (``room``):
    then no frame is dropped, whatever the encoder's pace."""

    def __init__(self, w, h, fps, room=None, **_kw):
        assert (w, h) == (W, H)
        self._frames = [np.roll(_base(), 3 * k, axis=0)
                        for k in range(N_SERVED)]
        self._room = room

    def start(self):
        pass

    def stop(self):
        pass

    def next_frame(self):
        if self._room is not None and not self._room():
            return None
        return self._frames.pop(0) if self._frames else None


def _serve(monkeypatch, batch):
    from selkies_tpu_torch.protocol.wire import unpack_binary
    from selkies_tpu_torch.server import data_server as tds

    monkeypatch.setenv("SELKIES_TPU_ASYNC_BATCH", str(batch))

    async def run():
        server = tds.DataStreamingServer(_settings("x264enc-striped"),
                                         device="cpu", host="127.0.0.1")

        def room():
            enc = server.display_clients["primary"].encoder
            return enc.stats()["submit_queue_depth"] < enc.submit_depth

        server.source_factory = functools.partial(_FiniteSource, room=room)
        ws = InProcessClient()
        task = asyncio.create_task(server.ws_handler(ws))
        ws.feed("SETTINGS," + json.dumps({
            "displayId": "primary", "initialClientWidth": W,
            "initialClientHeight": H, "framerate": 30}))
        frames, acked = {}, set()
        loop = asyncio.get_running_loop()
        deadline = loop.time() + 120.0
        while len(frames) < N_SERVED and loop.time() < deadline:
            await asyncio.sleep(0.01)
            for m in list(ws.sent):
                if isinstance(m, (bytes, bytearray)):
                    f = unpack_binary(bytes(m))
                    assert m[0] == 0x04
                    frames.setdefault(f.frame_id, set()).add(bytes(m))
                    if f.frame_id not in acked:
                        acked.add(f.frame_id)
                        ws.feed(f"CLIENT_FRAME_ACK {f.frame_id}")
        enc = server.display_clients["primary"].encoder
        stats = (enc.pipe.batch, enc.stats())
        await ws.close()
        await asyncio.wait_for(task, 30.0)
        await server.stop()
        return frames, stats

    return asyncio.run(run())


def test_batched_server_serves_the_one_frame_servers_0x04_frames(
        monkeypatch):
    want, (b1, st1) = _serve(monkeypatch, 1)
    got, (b3, st3) = _serve(monkeypatch, 3)
    assert (b1, b3) == (1, 3)
    assert len(want) == N_SERVED
    assert got == want
    assert st3["encode_errors"] == 0 and st3["frames_dropped"] == 0

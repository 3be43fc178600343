"""The port's multi-session lanes against the JAX package's, on the CPU.

The JAX lanes run on the conftest's virtual CPU devices as a mesh of
``session`` axis 4 and ``stripe`` axis 1 (one session per device); the
port's run on ``device="cpu"`` as one lane of 4 slots. The same numpy
frames from a seed go through both, tick by tick, with idle (None) slots,
``force_keyframe``, ``reset_session``, paint-over and overflowed stripes:

* ``MeshStripeEncoder``: equal ``StripeOutput`` bytes and
  ``session_bytes`` for every session on every tick (tolerance: none);
* ``MeshH264Encoder`` on both entropy tiers: equal Annex-B per stripe and
  coded bytes per session, every tick — the join IDR, an idle keyframe,
  a reset, paint-over and an overflowed stripe (QP 0) included. The JAX
  lane searches motion with its XLA chunked search (``me="xla"``, as
  ``tests/test_parallel.py`` runs it on the CPU; its winners are the
  Pallas kernel's, which ``tests/test_torch_h264_ops.py`` holds against
  the port's motion search);
* ``BatchedSessionEncoder``: equal coefficients, damage and rate feedback.

Then the port's lanes against the port's solo encoders (the counterparts
of ``tests/test_parallel.py``'s solo oracles), a slot reset with ticks in
flight, and the mesh spec's errors. (One kernel launch per lane tick is a
card test, ``tests/test_torch_cuda.py``: the wrappers count launches of
their kernels only.)
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax  # noqa: E402

from selkies_tpu.parallel import mesh as jmesh  # noqa: E402
from selkies_tpu.parallel import mesh_h264 as jmesh_h264  # noqa: E402
from selkies_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from selkies_tpu_torch.parallel import mesh_h264 as tmesh_h264  # noqa: E402

W, H, SH, N = 64, 64, 16, 4
S = H // SH


@pytest.fixture(scope="module")
def jax_mesh():
    if len(jax.devices()) < N:
        pytest.skip("needs 4 virtual devices")
    return jmesh.parse_mesh_spec(f"session:{N}", jax.devices()[:N])


@pytest.fixture(scope="module")
def port_mesh():
    return tmesh.parse_mesh_spec("session:1", [torch.device("cpu")])


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


def _jpeg_script():
    """(control, frames) per tick: noise and smooth content (at quality 100
    noise overflows the packer's 512-bit block budget, so those stripes
    are host-coded), an idle slot with a keyframe request, a reset slot, and
    static ticks up to paint-over (trigger 2)."""
    rng = np.random.default_rng(5)
    noise = [rng.integers(0, 256, (H, W, 3), np.uint8) for _ in range(N)]
    smooth = [_content(10 + n) for n in range(N)]
    part = [f.copy() for f in smooth]
    part[2][SH:2 * SH] = noise[2][SH:2 * SH]
    return [
        ((), noise),
        ((), smooth),
        ((("force_keyframe", 2),), [smooth[0], None, None, smooth[3]]),
        ((), part),
        ((("reset_session", 1),), [smooth[0], _content(99), part[2],
                                   smooth[3]]),
        ((), [smooth[0], _content(99), part[2], None]),
        ((), [smooth[0], _content(99), part[2], smooth[3]]),
        ((), [smooth[0], None, part[2], smooth[3]]),
    ]


JPEG_TICKS = len(_jpeg_script())


@pytest.fixture(scope="module")
def jpeg_runs(jax_mesh, port_mesh):
    # quality 100: the noise blocks pass the packer's 512-bit block budget
    kw = dict(stripe_h=SH, paint_over_trigger_frames=2, quality=100)
    jenc = jmesh.MeshStripeEncoder(jax_mesh, N, W, H, **kw)
    tenc = tmesh.MeshStripeEncoder(port_mesh, N, W, H, **kw)
    runs = []
    for ctl, frames in _jpeg_script():
        for name, arg in ctl:
            getattr(jenc, name)(arg)
            getattr(tenc, name)(arg)
        if all(f is not None for f in frames):
            frames = np.stack(frames)
        jout, jbytes = jenc.encode_frames(frames)
        tout, tbytes = tenc.encode_frames(frames)
        runs.append(((_jpeg_of(jout), list(jbytes)),
                     (_jpeg_of(tout), list(tbytes))))
    return jenc, tenc, runs


@pytest.mark.parametrize("tick", range(JPEG_TICKS))
def test_jpeg_lane_equals_jax(jpeg_runs, tick):
    want, got = jpeg_runs[2][tick]
    for n in range(N):
        assert got[0][n] == want[0][n], f"session {n}"
    assert got[1] == want[1]


@pytest.mark.parametrize("chunk", [1, 3])
def test_jpeg_lane_packs_in_chunks_changes_no_byte(jpeg_runs, monkeypatch,
                                                   chunk):
    """The lane's Huffman pack over chunks of 1 and of 3 sessions (full
    chunks and a remainder) gives the bytes of one pack over all four."""
    monkeypatch.setattr(tmesh, "PACK_SESSIONS", chunk)
    kw = dict(stripe_h=SH, paint_over_trigger_frames=2, quality=100)
    tenc = tmesh.MeshStripeEncoder(
        tmesh.parse_mesh_spec("session:1", [torch.device("cpu")]), N, W, H,
        **kw)
    for tick, (ctl, frames) in enumerate(_jpeg_script()):
        for name, arg in ctl:
            getattr(tenc, name)(arg)
        if all(f is not None for f in frames):
            frames = np.stack(frames)
        out, session_bytes = tenc.encode_frames(frames)
        assert (_jpeg_of(out), list(session_bytes)) == jpeg_runs[2][tick][1]


def test_jpeg_lane_script_covers_every_case(jpeg_runs):
    _, tenc, runs = jpeg_runs
    out = [r[1][0] for r in runs]
    assert all(len(out[0][n]) == S for n in range(N))       # first frame
    assert tenc.host_fallback_stripes_total > 0             # overflowed
    assert out[2][1] == [] and out[2][2] == []              # idle slots
    assert len(out[3][2]) == S                              # keyframe fired
    assert len(out[4][1]) == S                              # reset slot
    assert any(s[2] for tick in out for sess in tick for s in sess)  # paint


# ---------------------------------------------------------------------------
# the striped H.264 lane, both tiers


def _h264_script():
    """(control, frames) per tick: the join IDR, motion, an idle slot
    whose keyframe request stays armed, the keyframe firing alone, a reset
    slot's IDR, paint-over (trigger 2), and at QP 0 a flat red → blue
    change whose chroma DC levels pass the CAVLC escape range and the
    sparse cells' int8 range (overflowed stripes: host-coded from their
    exact levels)."""
    base = [_content(20 + n) for n in range(N)]
    roll = [[np.roll(b, 4 * k, axis=0) for b in base] for k in range(3)]
    red = np.zeros((H, W, 3), np.uint8)
    red[..., 0] = 255
    blue = np.zeros((H, W, 3), np.uint8)
    blue[..., 2] = 255
    blue[:SH] = red[:SH]                      # stripe 0 stays static
    new = _content(77)
    r2 = roll[2]
    return [
        ((), roll[0]),
        ((), roll[1]),
        ((("force_keyframe", 2),), [r2[0], r2[1], None, r2[3]]),
        ((), [r2[0], r2[1], roll[1][2], r2[3]]),
        ((("reset_session", 1),), [r2[0], new, roll[1][2], r2[3]]),
        ((), [r2[0], new, roll[1][2], red]),
        ((("qp", 0),), [r2[0], np.roll(new, 2, 1), roll[1][2], blue]),
        ((("qp", 26),), [r2[0], np.roll(new, 2, 1), None, blue]),
        ((), [None, np.roll(new, 2, 1), roll[1][2], blue]),
    ]


H264_TICKS = len(_h264_script())


@pytest.fixture(scope="module", params=["device", "host"])
def h264_runs(request, jax_mesh, port_mesh):
    # a ±4 search (motion here is 2-4 pixels) keeps the two JAX programs'
    # compiles to about 40 s
    kw = dict(stripe_h=SH, paint_over_trigger_frames=2, search=4,
              entropy=request.param)
    jenc = jmesh_h264.MeshH264Encoder(jax_mesh, N, W, H, me="xla", **kw)
    tenc = tmesh_h264.MeshH264Encoder(port_mesh, N, W, H, **kw)
    runs = []
    for ctl, frames in _h264_script():
        for name, arg in ctl:
            if name == "qp":
                jenc.qp = tenc.qp = arg
            else:
                getattr(jenc, name)(arg)
                getattr(tenc, name)(arg)
        if all(f is not None for f in frames):
            frames = np.stack(frames)
        jout, jbytes = jenc.encode_frames(frames)
        tout, tbytes = tenc.encode_frames(frames)
        runs.append(((_h264_of(jout), list(jbytes)),
                     (_h264_of(tout), list(tbytes))))
    return request.param, jenc, tenc, runs


@pytest.mark.parametrize("tick", range(H264_TICKS))
def test_h264_lane_equals_jax(h264_runs, tick):
    want, got = h264_runs[3][tick]
    for n in range(N):
        assert got[0][n] == want[0][n], f"session {n}"
    assert got[1] == want[1]


def test_h264_lane_script_covers_every_case(h264_runs):
    _, jenc, tenc, runs = h264_runs
    out = [r[1][0] for r in runs]
    assert all(len(out[0][n]) == S and all(s[3] for s in out[0][n])
               for n in range(N))                           # join IDR
    assert all(not s[3] for s in out[1][0])                 # P frames
    assert out[2][2] == []                                  # idle slot
    assert len(out[3][2]) == S and all(s[3] for s in out[3][2])
    assert all(out[3][n] == [] for n in (0, 1, 3))          # the rest quiet
    assert len(out[4][1]) == S and all(s[3] for s in out[4][1])  # reset
    assert out[5][0]                                        # paint-over
    assert tenc.host_fallback_stripes_total > 0             # overflowed
    assert tenc.host_fallback_stripes_total == \
        jenc.host_fallback_stripes_total


def test_h264_lane_reference_planes_equal_jax(h264_runs):
    _, jenc, tenc, _ = h264_runs
    for name in ("_prev_y", "_prev_cb", "_prev_cr",
                 "_ref_y", "_ref_cb", "_ref_cr"):
        assert np.array_equal(tenc.gathered(name[1:]).numpy(),
                              np.asarray(getattr(jenc, name))), name


# ---------------------------------------------------------------------------
# the step without entropy coding


def test_batched_session_encoder_equals_jax(jax_mesh, port_mesh):
    rng = np.random.default_rng(7)
    frames = rng.integers(0, 256, (N, H, W, 3), dtype=np.uint8)
    qsel = np.zeros((N, S), np.int32)
    qsel[1, 2] = 1                            # one paint-over stripe
    jenc = jmesh.BatchedSessionEncoder(jax_mesh, N, W, H, stripe_h=SH)
    tenc = tmesh.BatchedSessionEncoder(port_mesh, N, W, H, stripe_h=SH)
    for step in range(2):                     # the second: no damage
        want = jenc.step(frames, qsel)
        got = tenc.step(frames, qsel)
        for a, b in zip(got, want):
            assert np.array_equal(a.numpy(), np.asarray(b)), step
    assert int(got[3].max()) == 0
    assert int(got[5]) == int(got[4].sum())


# ---------------------------------------------------------------------------
# the port's lanes against its solo encoders


def _frame_seq(seed, n_frames):
    """Random → static → one stripe changed → static."""
    rng = np.random.default_rng(seed)
    f0 = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
    seq = [f0, f0.copy()]
    f2 = f0.copy()
    f2[H // 2:H // 2 + SH] = rng.integers(0, 256, (SH, W, 3), np.uint8)
    seq.append(f2)
    while len(seq) < n_frames:
        seq.append(seq[-1].copy())
    return seq


def test_jpeg_lane_equals_port_solo(port_mesh):
    from selkies_tpu_torch.encoder.jpeg import JpegStripeEncoder

    seqs = [_frame_seq(100 + n, 5) for n in range(N)]
    lane = tmesh.MeshStripeEncoder(port_mesh, N, W, H, stripe_h=SH,
                                   paint_over_trigger_frames=2)
    solos = [JpegStripeEncoder(W, H, stripe_height=SH,
                               paint_over_trigger_frames=2, device="cpu")
             for _ in range(N)]
    for t in range(5):
        out, session_bytes = lane.encode_frames(
            np.stack([seqs[n][t] for n in range(N)]))
        for n in range(N):
            solo = solos[n].encode_frame(seqs[n][t])
            assert _jpeg_of([out[n]]) == _jpeg_of([solo]), (t, n)
            assert session_bytes[n] > 0


def test_h264_lane_equals_port_solo(port_mesh):
    """Every session's Annex-B equals a solo encoder's on the same frames
    (a join IDR for all, motion, static, one changed stripe)."""
    from selkies_tpu_torch.encoder.h264 import H264StripeEncoder

    def seq(seed):
        f0 = _content(seed)
        f1 = np.roll(f0, 4, axis=0)
        f3 = f1.copy()
        f3[H // 2:H // 2 + SH] = _content(seed + 50)[:SH]
        return [f0, f1, f1.copy(), f3, f3.copy(), f3.copy()]

    seqs = [seq(200 + n) for n in range(N)]
    lane = tmesh_h264.MeshH264Encoder(port_mesh, N, W, H, stripe_h=SH,
                                      paint_over_trigger_frames=2)
    solos = [H264StripeEncoder(W, H, stripe_height=SH,
                               paint_over_trigger_frames=2, device="cpu")
             for _ in range(N)]
    for t in range(6):
        out, _ = lane.encode_frames(np.stack([seqs[n][t] for n in range(N)]))
        for n in range(N):
            solo = solos[n].encode_frame(seqs[n][t])
            assert _h264_of([out[n]]) == _h264_of([solo]), (t, n)


@pytest.mark.parametrize("profile", ["jpeg", "x264enc-striped"])
def test_reset_slot_leaks_nothing_to_the_next_occupant(port_mesh, profile):
    """A slot reset while two ticks are in flight (the scheduler's window;
    the first is the old occupant's join keyframe): the in-flight ticks
    still code the old occupant's frames, the slot's planes and
    re-present frame are zero after them, an idle tick emits nothing, and
    the new occupant's first two frames — a keyframe, then a P frame —
    equal a fresh solo encoder's, byte for byte (H.264: with the slot's
    next idr_pic_id, which a reset keeps counting, as in the JAX lane);
    the other slots are untouched."""
    from selkies_tpu_torch.encoder.h264 import H264StripeEncoder
    from selkies_tpu_torch.encoder.jpeg import JpegStripeEncoder

    old = [_content(30 + n) for n in range(N)]
    new = [_content(60), np.roll(_content(60), 4, axis=0)]
    if profile == "jpeg":
        lane = tmesh.MeshStripeEncoder(port_mesh, N, W, H, stripe_h=SH)
        solo = JpegStripeEncoder(W, H, stripe_height=SH, device="cpu")
        of, planes = _jpeg_of, ("_prev",)
    else:
        lane = tmesh_h264.MeshH264Encoder(port_mesh, N, W, H, stripe_h=SH)
        solo = H264StripeEncoder(W, H, stripe_height=SH, device="cpu")
        of = _h264_of
        planes = ("_prev_y", "_prev_cb", "_prev_cr", "_ref_y", "_ref_cb",
                  "_ref_cr")
    first = lane.dispatch(np.stack(old))
    second = lane.dispatch([np.roll(f, 2, axis=1) for f in old])
    lane.reset_session(1)
    out_a, _ = lane.harvest(first)
    out_b, _ = lane.harvest(second)
    assert len(out_a[1]) == S and out_b[1]          # the old occupant coded
    for name in planes:
        t = lane.gathered(name[1:])
        assert not t[1].any() and t[0].any(), name
    assert not lane.last_frames[1].any()
    idle, _ = lane.encode_frames([np.roll(old[0], 2, axis=1), None,
                                  np.roll(old[2], 2, axis=1), None])
    assert idle[1] == []
    if profile != "jpeg":
        for i, st in enumerate(solo.stripes):
            st.idr_pic_id = int(lane._idr_pic_id[1, i])
    for k, f in enumerate(new):
        frames = [np.roll(old[0], 2, axis=1), f,
                  np.roll(old[2], 2, axis=1), np.roll(old[3], 2, axis=1)]
        out, _ = lane.encode_frames(frames)
        assert of([out[1]]) == of([solo.encode_frame(f)]), k


# ---------------------------------------------------------------------------
# launches, devices, specs


@pytest.mark.parametrize("profile", ["jpeg", "x264enc-striped"])
@pytest.mark.parametrize("spec", ["session:1,stripe:2", "session:2"])
def test_lanes_over_two_devices_equal_one_device(spec, profile):
    """A stripe axis (split-frame encoding) or a session axis over two
    devices: both lane encoders build over two CPU devices, and every
    session's bytes equal the one-device lane's, tick by tick (a join
    keyframe, motion, an idle slot, a static tick, one changed stripe)."""
    cpu = torch.device("cpu")
    two = tmesh.parse_mesh_spec(spec, [cpu, cpu])
    one = tmesh.parse_mesh_spec("session:1", [cpu])
    if profile == "jpeg":
        make, of = tmesh.MeshStripeEncoder, _jpeg_of
    else:
        make, of = tmesh_h264.MeshH264Encoder, _h264_of
    lanes = [make(m, 2, W, H, stripe_h=SH, paint_over_trigger_frames=2)
             for m in (one, two)]
    assert lanes[1].n_shards == (2 if "stripe" in spec else 1)
    a, b = _content(41), _content(42)
    a2 = np.roll(a, 4, axis=0)
    b2 = b.copy()
    b2[H // 2:H // 2 + SH] = _content(43)[:SH]
    for t, frames in enumerate([[a, b], [a2, None], [a2, b], [a2, b2],
                                [a2, b2]]):
        want, wbytes = lanes[0].encode_frames(frames)
        got, gbytes = lanes[1].encode_frames(frames)
        assert of(got) == of(want), t
        assert list(gbytes) == list(wbytes), t


SPECS = ["session:4,stripe:2", "session:8", "session:64", "tensor:2",
         "session:2,,stripe:1"]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_mesh_spec_equals_jax(spec):
    """Axis sizes and errors (the same messages) as the JAX package's,
    over 8 devices."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")

    def run(parse, devices):
        try:
            m = parse(spec, devices)
            return m.shape["session"], m.shape["stripe"]
        except ValueError as e:
            return str(e)

    want = run(jmesh.parse_mesh_spec, jax.devices()[:8])
    assert run(tmesh.parse_mesh_spec,
               [torch.device("cpu")] * 8) == want


def test_make_mesh_axes():
    cpu = torch.device("cpu")
    assert tmesh.make_mesh([cpu] * 8).shape == {"session": 4, "stripe": 2}
    assert tmesh.make_mesh([cpu] * 3).shape == {"session": 3, "stripe": 1}
    with pytest.raises(ValueError):
        tmesh.make_mesh([cpu] * 3, stripe_axis=2)


def test_default_devices_need_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        tmesh.parse_mesh_spec("session:1")

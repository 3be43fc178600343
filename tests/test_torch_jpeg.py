"""The port's JPEG-stripe encoder against the JAX one, byte for byte.

Same synthetic frames into both; every emitted stripe (y_start, paint-over
flag, JFIF bytes) must be identical, through the synchronous encode_frame,
through PipelinedJpegEncoder + AsyncEncodeDriver, and after resuming the
port from an exported JAX state mid-stream."""

import io

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from selkies_tpu.capture.synthetic import SyntheticSource as JSource
from selkies_tpu.encoder.jpeg import JpegStripeEncoder as JEnc
from selkies_tpu_torch.capture.synthetic import SyntheticSource as TSource
from selkies_tpu_torch.encoder.async_driver import AsyncEncodeDriver
from selkies_tpu_torch.encoder.jpeg import JpegStripeEncoder as TEnc
from selkies_tpu_torch.encoder.pipeline import PipelinedJpegEncoder
from selkies_tpu_torch.encoder.staging import StagingRing, StagingTicket
from selkies_tpu_torch.encoder.state import (export_encoder_state,
                                             load_encoder_state)

W, H = 256, 120            # pads to 128 rows: two 64-row stripes


def _sequence(n_moving=3, n_static=5, seed=3):
    """Moving frames, then a static run long enough for paint-over, then
    motion again, then a noise frame whose paint-over stripes overflow the
    device pack budget (host-coded)."""
    src = JSource(W, H, pattern="desktop", seed=seed)
    fr = [src.next_frame() for _ in range(n_moving)]
    fr += [fr[-1]] * n_static
    fr.append(src.next_frame())
    rng = np.random.default_rng(seed)
    fr.append(rng.integers(0, 256, (H, W, 3), dtype=np.uint8))
    fr += [fr[-1]] * 3
    return fr


def _key(stripes):
    return [(s.y_start, s.height, s.is_paintover, s.jpeg) for s in stripes]


def _kw():
    return dict(stripe_height=64, quality=40, paintover_quality=100,
                paint_over_trigger_frames=2)


def test_synthetic_source_is_a_copy():
    for pattern in ("desktop", "scroll", "noise"):
        a, b = JSource(W, H, pattern=pattern, seed=1), TSource(W, H, pattern=pattern, seed=1)
        for _ in range(3):
            assert np.array_equal(a.next_frame(), b.next_frame())


def test_encode_frame_byte_identical_with_paint_over():
    frames = _sequence()
    je, te = JEnc(W, H, **_kw()), TEnc(W, H, device="cpu", **_kw())
    saw_paint = False
    for f in frames:
        a, b = je.encode_frame(f), te.encode_frame(f)
        assert _key(a) == _key(b)
        saw_paint |= any(s.is_paintover for s in b)
    assert saw_paint
    # the q100 noise paint-over overflows the 16-word block budget: both
    # encoders host-coded the same stripes
    assert te.host_fallback_stripes_total > 0
    assert te.host_fallback_stripes_total == je.host_fallback_stripes_total


def test_static_frames_emit_nothing_and_one_pixel_emits_one_stripe():
    te = TEnc(W, H, device="cpu", use_paint_over_quality=False)
    f = TSource(W, H, pattern="static").next_frame()
    assert len(te.encode_frame(f)) == 2          # first frame: every stripe
    assert te.encode_frame(f) == []
    g = f.copy()
    g[100, 10, 0] ^= 1
    out = te.encode_frame(g)
    assert [s.y_start for s in out] == [64]


def test_pipelined_in_flight_byte_identical():
    """Many frames in flight at once (fetch groups of two). Without
    paint-over the emitted stripes do not depend on harvest timing, so they
    must equal the JAX encoder's, frame by frame."""
    kw = dict(stripe_height=64, quality=40, use_paint_over_quality=False)
    frames = _sequence()
    je = JEnc(W, H, **kw)
    want = [_key(je.encode_frame(f)) for f in frames]
    pipe = PipelinedJpegEncoder(TEnc(W, H, device="cpu", **kw),
                                depth=4, fetch_group=2)
    got = {}
    for f in frames:
        pipe.submit(f)
        got.update(dict(pipe.poll(flush_partial=False)))
    got.update(dict(pipe.flush()))
    assert [_key(got[i]) for i in range(len(frames))] == want
    st = pipe.stats()
    assert st["frames"] == len(frames) and st["inflight_batches_max"] >= 1
    assert st["d2h_bytes_per_frame"] > 0


def test_async_driver_byte_identical_with_paint_over():
    """Through PipelinedJpegEncoder + AsyncEncodeDriver, one frame settled
    before the next (paint-over candidacy reads the harvested history),
    against the JAX encoder: identical bytes, paint-over included."""
    frames = _sequence()
    je = JEnc(W, H, **_kw())
    want = [_key(je.encode_frame(f)) for f in frames]
    drv = AsyncEncodeDriver(PipelinedJpegEncoder(
        TEnc(W, H, device="cpu", **_kw()), depth=4, fetch_group=2))
    got = {}
    seqs = []
    for f in frames:
        seqs.append(drv.try_submit(f))
        got.update(dict(drv.flush()))
    drv.close()
    assert seqs == list(range(len(frames)))
    assert [_key(got[i]) for i in seqs] == want
    assert any(s.is_paintover for i in seqs for s in got[i])
    st = drv.stats()
    assert st["frames"] == len(frames) and st["encode_errors"] == 0
    assert st["host_fallback_stripes"] == je.host_fallback_stripes_total > 0


def test_pipeline_bounded_inflight_and_flush():
    te = TEnc(W, H, device="cpu")
    pipe = PipelinedJpegEncoder(te, depth=2, fetch_group=2)
    frames = _sequence()[:6]
    accepted = [pipe.try_submit(f) for f in frames]
    assert pipe.n_inflight <= 2
    assert accepted[:2] == [0, 1] and None in accepted
    assert pipe.frames_dropped_total == accepted.count(None)
    out = pipe.poll() + pipe.flush()
    assert [seq for seq, _ in out] == [a for a in accepted if a is not None]
    assert pipe.n_inflight == 0 and pipe._staging.in_use == 0
    # a closed pipeline leaves no busy staging slot behind
    pipe.submit(frames[0])
    pipe.close()
    assert pipe._staging.in_use == 0 and pipe.n_inflight == 0


def test_staging_ring_guard_and_generations():
    ring = StagingRing(depth=2)
    f = np.zeros((4, 4, 3), np.uint8)
    a, ta = ring.stage(f)
    b, tb = ring.stage(f + 1)
    assert ta != tb and ring.in_use == 2
    c, tc = ring.stage(f + 2)            # every slot held: fresh buffer
    assert tc is None and ring.stalls_total == 1
    assert int(a[0, 0, 0]) == 0 and int(c[0, 0, 0]) == 2
    ring.release(ta)
    d, td = ring.stage(f + 3)
    assert td == ta and int(d[0, 0, 0]) == 3
    # a shape change retires the lane: old tickets are no-ops
    ring.stage(np.zeros((8, 4, 3), np.uint8))
    ring.release(tb)
    assert ring.in_use == 1
    t = StagingTicket(ring, ring.stage(np.zeros((8, 4, 3), np.uint8))[1], refs=2)
    t.release()
    assert ring.in_use == 2
    t.release()
    assert ring.in_use == 1


def _jax_state(enc):
    return {
        "qy": np.asarray(enc._qy), "qc": np.asarray(enc._qc),
        "prev": np.asarray(enc._prev),
        "static_frames": enc._static_frames.copy(),
        "painted": enc._painted.copy(),
        "first_frame": np.asarray(enc._first_frame),
    }


def test_resume_from_exported_jax_state():
    """Run the JAX encoder up to one frame before a paint-over fires,
    export its state, resume the port from it, and compare what follows."""
    frames = _sequence()
    je = JEnc(W, H, **_kw())
    k = 4                                  # static frames 3.. : paint at 5
    for f in frames[:k]:
        je.encode_frame(f)
    te = TEnc(W, H, device="cpu", **_kw())
    load_encoder_state(te, _jax_state(je))
    fired = False
    for f in frames[k:]:
        a, b = je.encode_frame(f), te.encode_frame(f)
        assert _key(a) == _key(b)
        fired |= any(s.is_paintover for s in b)
    assert fired
    # and the port's own export round-trips
    st = export_encoder_state(te)
    te2 = TEnc(W, H, device="cpu", **_kw())
    load_encoder_state(te2, st)
    f = frames[2]
    assert _key(te.encode_frame(f)) == _key(te2.encode_frame(f))


def test_load_state_rejects_wrong_geometry():
    te = TEnc(W, H, device="cpu")
    st = export_encoder_state(te)
    st["prev"] = np.zeros((64, 64, 3), np.uint8)
    with pytest.raises(ValueError):
        load_encoder_state(te, st)
    del st["prev"]
    with pytest.raises(KeyError):
        load_encoder_state(te, st)


def test_stripes_decode_in_pil():
    Image = pytest.importorskip("PIL.Image")
    te = TEnc(W, H, device="cpu", quality=80)
    src = TSource(W, H, pattern="desktop", seed=2)
    f = src.next_frame()
    stripes = te.encode_frame(f)
    assert len(stripes) == 2
    padded = te._pad(f)
    for s in stripes:
        img = np.asarray(Image.open(io.BytesIO(s.jpeg)).convert("RGB"))
        assert img.shape == (64, te.pad_w, 3)
        ref = padded[s.y_start:s.y_start + 64].astype(np.float64)
        mse = np.mean((img.astype(np.float64) - ref) ** 2)
        assert 10 * np.log10(255.0 ** 2 / mse) > 30.0


def test_watermark_blend_matches_jax(tmp_path):
    Image = pytest.importorskip("PIL.Image")
    rng = np.random.default_rng(7)
    mark = rng.integers(0, 256, (20, 30, 4), dtype=np.uint8)
    path = tmp_path / "mark.png"
    Image.fromarray(mark, "RGBA").save(path)
    kw = dict(stripe_height=64, watermark_path=str(path), watermark_location=3)
    je, te = JEnc(W, H, **kw), TEnc(W, H, device="cpu", **kw)
    src = JSource(W, H, pattern="desktop", seed=4)
    for _ in range(3):
        f = src.next_frame()
        assert _key(je.encode_frame(f)) == _key(te.encode_frame(f))


def test_force_keyframe_reemits_every_stripe():
    te = TEnc(W, H, device="cpu")
    f = TSource(W, H, pattern="static").next_frame()
    te.encode_frame(f)
    assert te.encode_frame(f) == []
    te.force_keyframe()
    assert len(te.encode_frame(f)) == 2

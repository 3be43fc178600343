"""The port's device frame source and the encoders' input path for frames
already on the device, on the CPU.

``DeviceScrollSource`` must give ``SyntheticSource(pattern="scroll")``'s
frames and the JAX package's ``DeviceScrollSource`` frames exactly, frame
by frame and batch by batch, past the wrap-around at t = height / 4. Frame
tensors on the encoder's device skip the staging ring and give the bytes
the same frames give as numpy arrays, through both pipelines (the JPEG
tensor pre-padded, as the JAX pipeline requires), the synchronous
encoders and the host-rung adapter; a tensor on another device, of
another type, or (JPEG) not padded raises. Each public entry point hands a
frame tensor over to the encoder stream once."""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from selkies_tpu.capture.synthetic import DeviceScrollSource as JaxSource  # noqa: E402
from selkies_tpu_torch.capture.synthetic import (DeviceScrollSource,  # noqa: E402
                                                 SyntheticSource)
from selkies_tpu_torch.encoder.async_driver import AsyncEncodeDriver  # noqa: E402
from selkies_tpu_torch.encoder.h264 import H264StripeEncoder  # noqa: E402
from selkies_tpu_torch.encoder.jpeg import JpegStripeEncoder  # noqa: E402
from selkies_tpu_torch.encoder.pipeline import (PipelinedH264Encoder,  # noqa: E402
                                                PipelinedJpegEncoder,
                                                ThreadedEncoderAdapter)

W, H = 128, 96


@pytest.mark.parametrize("seed", [0, 5])
def test_frames_equal_the_host_source_and_jax_past_the_wrap(seed):
    """30 single frames, then batches of 7 and 9: 46 frames, the roll
    wrapping at frame 24 (4 rows a frame over 96 rows)."""
    ours = DeviceScrollSource(W, H, seed=seed, device="cpu")
    host = SyntheticSource(W, H, pattern="scroll", seed=seed)
    ref = JaxSource(W, H, seed=seed)
    for k in range(30):
        f = ours.next_frame()
        assert f.dtype == torch.uint8 and f.shape == (H, W, 3)
        want = host.next_frame()
        assert np.array_equal(f.numpy(), want), f"frame {k}"
        assert np.array_equal(np.asarray(ref.next_frame()), want)
    for n in (7, 9):
        b = ours.next_batch(n)
        assert b.shape == (n, H, W, 3)
        want = np.asarray(ref.next_batch(n))
        assert np.array_equal(b.numpy(), want)
        for i in range(n):
            assert np.array_equal(want[i], host.next_frame())


def test_the_source_runs_on_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is the card")
    with pytest.raises(RuntimeError):
        DeviceScrollSource(W, H)


#: the JPEG frames' height: 90 rows pad to three 32-row stripes
JH = 90


def _jpeg(entropy="device"):
    return JpegStripeEncoder(W, JH, stripe_height=32, device="cpu",
                             paint_over_trigger_frames=2, entropy=entropy)


def _padded(frame, pad_h):
    """The frame tensor padded to ``pad_h`` rows by edge replication, as
    the encoder pads a host frame."""
    rows = torch.arange(pad_h).clamp(max=frame.shape[0] - 1)
    return frame.index_select(0, rows)


def _jpeg_bytes(out):
    return [(s.y_start, s.is_paintover, s.jpeg) for s in out]


def _h264_bytes(out):
    return [(s.y_start, s.is_key, s.annexb) for s in out]


def _scroll_then_still(n_move, n_still, height=H):
    src = DeviceScrollSource(W, height, seed=2, device="cpu")
    moving = [src.next_frame() for _ in range(n_move)]
    return moving + [moving[-1].clone() for _ in range(n_still)]


def test_jpeg_pipeline_takes_padded_tensors_as_numpy_frames():
    """Pre-padded frame tensors skip the staging ring; the stripes equal
    the same frames' as host arrays (paint-over included)."""
    base = _jpeg()
    frames = _scroll_then_still(4, 4, height=JH)
    assert base.pad_h == 96
    want_pipe = PipelinedJpegEncoder(_jpeg(), depth=3, fetch_group=2)
    for f in frames:
        want_pipe.submit(f.numpy())
    want = dict(want_pipe.flush())
    pipe = PipelinedJpegEncoder(base, depth=3, fetch_group=2)
    for f in frames:
        pipe.submit(_padded(f, base.pad_h))
    got = dict(pipe.flush())
    assert pipe._staging.staged_total == 0
    assert sorted(got) == sorted(want) == list(range(len(frames)))
    for k in got:
        assert _jpeg_bytes(got[k]) == _jpeg_bytes(want[k]), f"frame {k}"
    assert any(s.is_paintover for k in got for s in got[k])


@pytest.mark.parametrize("entropy", ["device", "host"])
def test_jpeg_encode_frame_takes_padded_tensors(entropy):
    frames = _scroll_then_still(3, 3, height=JH)
    a, b = _jpeg(entropy), _jpeg(entropy)
    for f in frames:
        assert _jpeg_bytes(a.encode_frame(_padded(f, a.pad_h))) == \
            _jpeg_bytes(b.encode_frame(f.numpy()))


def test_jpeg_refuses_tensors_it_cannot_take():
    enc = _jpeg()
    ok = torch.zeros((enc.pad_h, enc.pad_w, 3), dtype=torch.uint8)
    with pytest.raises(ValueError):
        enc.encode_frame(ok[:JH])                         # not padded
    with pytest.raises(ValueError):
        enc.encode_frame(ok.to(torch.int16))              # not uint8
    with pytest.raises(ValueError):
        enc.encode_frame(torch.empty(ok.shape, dtype=torch.uint8,
                                     device="meta"))      # another device
    pipe = PipelinedJpegEncoder(enc, depth=2)
    with pytest.raises(ValueError):
        pipe.submit(ok[:JH])
    assert pipe.n_inflight == 0 and pipe._staging.in_use == 0


@pytest.mark.parametrize("entropy", ["device", "host"])
@pytest.mark.parametrize("batch", [1, 3])
def test_h264_pipeline_takes_tensors_as_numpy_frames(entropy, batch):
    """Frame tensors one by one and (batch 3) ``next_batch`` stacks give
    the Annex-B of the same frames as host arrays."""
    kw = dict(stripe_height=32, device="cpu", entropy=entropy)
    want_enc = H264StripeEncoder(W, H, **kw)
    src = DeviceScrollSource(W, H, seed=4, device="cpu")
    frames = [src.next_frame() for _ in range(3)]
    batches = [src.next_batch(3) for _ in range(2)]
    flat = frames + [b[i] for b in batches for i in range(3)]
    want = [_h264_bytes(want_enc.encode_frame(f.numpy())) for f in flat]

    pipe = PipelinedH264Encoder(H264StripeEncoder(W, H, **kw), depth=9,
                                batch=batch)
    for f in frames:
        pipe.submit(f)
    got = dict(pipe.flush())
    for b in batches:
        if batch == 3:
            pipe.submit_batch(b)
        else:
            for i in range(3):
                pipe.submit(b[i])
        got.update(pipe.flush())
    assert pipe._staging.staged_total == 0
    assert pipe._staging_batch.staged_total == 0
    assert [_h264_bytes(got[k]) for k in range(len(flat))] == want


def test_h264_refuses_a_tensor_on_another_device():
    enc = H264StripeEncoder(W, H, stripe_height=32, device="cpu")
    pipe = PipelinedH264Encoder(enc, depth=4, batch=3)
    meta = torch.empty((H, W, 3), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError):
        pipe.submit(meta)
    with pytest.raises(ValueError):
        pipe.submit_batch(meta[None].expand(3, H, W, 3))
    with pytest.raises(ValueError):
        enc.encode_frame(meta)
    assert pipe.n_held == 0 and pipe.n_inflight == 0


@pytest.mark.parametrize("codec", ["jpeg", "h264"])
def test_host_rung_adapter_takes_tensors(codec):
    """The threaded adapter hands a tensor over in the caller's thread and
    encodes it as the host array."""
    if codec == "jpeg":
        make, key = (lambda: _jpeg("host")), _jpeg_bytes
        host = [f.numpy() for f in _scroll_then_still(3, 2, height=JH)]
        frames = [_padded(torch.from_numpy(f), 96) for f in host]
    else:
        def make():
            return H264StripeEncoder(W, H, stripe_height=32, device="cpu",
                                     entropy="host")
        key = _h264_bytes
        frames = _scroll_then_still(3, 2)
        host = [f.numpy() for f in frames]
    want = [key(x) for x in map(make().encode_frame, host)]
    adapter = ThreadedEncoderAdapter(make(), depth=len(frames))
    try:
        for f in frames:
            assert adapter.submit(f) is not None
        got = dict(adapter.flush(60.0))
    finally:
        adapter.close()
        assert adapter.join(30.0)
    assert [key(got[k]) for k in range(len(frames))] == want


def _h264(entropy="device"):
    return H264StripeEncoder(W, H, stripe_height=32, device="cpu",
                             entropy=entropy)


def _through_driver(frames, batch):
    drv = AsyncEncodeDriver(PipelinedH264Encoder(_h264(), depth=9,
                                                 batch=batch),
                            flush_partial_when_idle=(batch == 1))
    try:
        assert all(drv.try_submit(f) is not None for f in frames)
        return drv.flush(60.0)
    finally:
        drv.close()
        assert drv.join(30.0)


def _through_adapter(frames):
    adapter = ThreadedEncoderAdapter(_h264("host"), depth=len(frames))
    try:
        assert all(adapter.submit(f) is not None for f in frames)
        return adapter.flush(60.0)
    finally:
        adapter.close()
        assert adapter.join(30.0)


def _h264_pipe(batch):
    return PipelinedH264Encoder(_h264(), depth=9, batch=batch)


#: entry point -> (drive it with 3 frame tensors, tensors handed over)
ENTRY_POINTS = {
    "encode_frame": (lambda fs: [_h264().encode_frame(f) for f in fs], 3),
    "pipeline.submit": (lambda fs: [_h264_pipe(3).submit(f) for f in fs], 3),
    "pipeline.try_submit":
        (lambda fs: [_h264_pipe(1).try_submit(f) for f in fs], 3),
    "pipeline.submit_batch":
        (lambda fs: _h264_pipe(3).submit_batch(torch.stack(fs)), 1),
    "driver.try_submit/batch1": (lambda fs: _through_driver(fs, 1), 3),
    "driver.try_submit/batch3": (lambda fs: _through_driver(fs, 3), 3),
    "adapter.submit": (_through_adapter, 3),
}


@pytest.mark.parametrize("entry", list(ENTRY_POINTS))
def test_each_entry_point_hands_a_frame_over_once(entry, monkeypatch):
    """A frame tensor is handed over to the encoder stream once, where it
    leaves its caller; the pipelines, the driver's thread, the adapter's
    worker and the encoders behind them take it as it is."""
    from selkies_tpu_torch.encoder import h264 as th264

    handed = []
    real = th264.adopt_frame

    def spy(frame, device, stream):
        handed.append(tuple(frame.shape))
        return real(frame, device, stream)

    monkeypatch.setattr(th264, "adopt_frame", spy)
    drive, n = ENTRY_POINTS[entry]
    drive(_scroll_then_still(3, 0))
    assert len(handed) == n, handed

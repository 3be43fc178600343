"""Frame sizes that are not a multiple of 16, port against the JAX package
on the CPU (tolerance 0).

A client window of 1366 or 1000 pixels pads: the encoders replicate the
edge into the padding, and the SPS (H.264) or the JFIF size (JPEG) crops
it. Same frames in, same bytes out, with each entropy tier:

* JPEG at 200x120 (padded to 208x128);
* ``x264enc-striped`` at 200x96 (208 wide, three 32-row stripes);
* ``x264enc`` at 184x90 (one full-frame stripe of 96x192);
* a 129x97 frame handed to a 128x96 host-rung adapter (the factory gives
  H.264 even dimensions, a source need not): both packages' adapters crop
  it to the encoder, for JPEG and for H.264.

The sequences: scrolled frames, a static run up to paint-over, a noise
frame. The JAX H.264 encoders search motion through the package's plain
reference of its Pallas kernel (``SELKIES_TPU_ME=scan``)."""

import numpy as np
import pytest

pytest.importorskip("jax")

from selkies_tpu.capture.synthetic import SyntheticSource  # noqa: E402
from selkies_tpu.encoder.h264 import H264StripeEncoder as JaxH264  # noqa: E402
from selkies_tpu.encoder.jpeg import JpegStripeEncoder as JaxJpeg  # noqa: E402
from selkies_tpu.encoder.pipeline import ThreadedEncoderAdapter as JaxAdapter  # noqa: E402
from selkies_tpu_torch.encoder.h264 import H264StripeEncoder  # noqa: E402
from selkies_tpu_torch.encoder.jpeg import JpegStripeEncoder  # noqa: E402
from selkies_tpu_torch.encoder.pipeline import ThreadedEncoderAdapter  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _plain_reference_search():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SELKIES_TPU_ME", "scan")
        yield


def _sequence(w, h, seed=1):
    """Four scrolled frames, four static ones (paint-over at the trigger
    of 2), a noise frame, and one more scrolled frame."""
    src = SyntheticSource(w, h, pattern="scroll", seed=seed)
    frames = [src.next_frame() for _ in range(4)]
    frames += [frames[-1]] * 4
    rng = np.random.default_rng(seed)
    frames.append(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
    frames.append(src.next_frame())
    return frames


def _jpeg_key(out):
    return [(s.y_start, s.height, s.is_paintover, s.jpeg) for s in out]


def _h264_key(out):
    return [(s.y_start, s.width, s.height, s.is_key, s.annexb) for s in out]


@pytest.mark.parametrize("entropy", ["device", "host"])
def test_jpeg_200x120(entropy):
    w, h = 200, 120
    kw = dict(stripe_height=64, quality=60, paint_over_trigger_frames=2,
              entropy=entropy)
    ref = JaxJpeg(w, h, **kw)
    port = JpegStripeEncoder(w, h, device="cpu", **kw)
    assert (port.pad_w, port.pad_h) == (208, 128)
    paint = 0
    for k, f in enumerate(_sequence(w, h)):
        got = _jpeg_key(port.encode_frame(f))
        assert got == _jpeg_key(ref.encode_frame(f)), f"frame {k}"
        paint += any(s[2] for s in got)
    assert paint == 1


H264_CASES = {
    "x264enc-striped": (200, 96, dict(stripe_height=32)),
    "x264enc": (184, 90, dict(fullframe=True)),
}


@pytest.mark.parametrize("entropy", ["device", "host"])
@pytest.mark.parametrize("profile", sorted(H264_CASES))
def test_h264_widths_not_a_multiple_of_16(profile, entropy):
    w, h, geo = H264_CASES[profile]
    kw = dict(paint_over_trigger_frames=2, entropy=entropy, **geo)
    ref = JaxH264(w, h, **kw)
    ref._prefix_small = ref._batch_prefix      # one compiled prefix tier
    port = H264StripeEncoder(w, h, device="cpu", **kw)
    assert port.pad_w % 16 == 0 and port.pad_w > w
    keys = 0
    for k, f in enumerate(_sequence(w, h)):
        got = _h264_key(port.encode_frame(f))
        assert got == _h264_key(ref.encode_frame(f)), f"frame {k}"
        keys += sum(s[3] for s in got)
    assert keys == port.n_stripes             # one IDR
    assert port.entropy_errors_total == 0


def _adapter_run(adapter, frames):
    for f in frames:
        assert adapter.submit(f) is not None
    if isinstance(adapter, ThreadedEncoderAdapter):
        out = dict(adapter.flush(60.0))
        adapter.close()
        assert adapter.join(30.0)
    else:
        out = dict(adapter.flush())
        adapter.close()
    return [out[k] for k in range(len(frames))]


@pytest.mark.parametrize("codec", ["jpeg", "h264"])
def test_oversized_frame_into_a_host_rung_adapter(codec):
    """129x97 frames into a 128x96 encoder behind each package's threaded
    adapter: cropped to the encoder, the same bytes."""
    frames = _sequence(129, 97, seed=2)
    if codec == "jpeg":
        kw = dict(stripe_height=32, paint_over_trigger_frames=2,
                  entropy="host")
        ref = JaxAdapter(JaxJpeg(128, 96, **kw), depth=len(frames))
        port = ThreadedEncoderAdapter(
            JpegStripeEncoder(128, 96, device="cpu", **kw),
            depth=len(frames))
        key = _jpeg_key
    else:
        kw = dict(stripe_height=32, paint_over_trigger_frames=2,
                  entropy="host")
        jenc = JaxH264(128, 96, **kw)
        jenc._prefix_small = jenc._batch_prefix
        ref = JaxAdapter(jenc, depth=len(frames))
        port = ThreadedEncoderAdapter(
            H264StripeEncoder(128, 96, device="cpu", **kw),
            depth=len(frames))
        key = _h264_key
    want = [key(x) for x in _adapter_run(ref, frames)]
    got = [key(x) for x in _adapter_run(port, frames)]
    assert got == want
    assert port.stats()["encode_errors"] == 0
    assert sum(len(x) for x in got) > 0

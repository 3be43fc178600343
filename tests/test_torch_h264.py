"""The port's x264enc-striped encoder against the JAX package's on the CPU.

Same frames in, same Annex-B bytes out (tolerance 0): an IDR, rolled P
frames, static frames up to paint-over, a mid-stream keyframe request, a
stripe that overflows the device coder into the host coder, and the
reference planes the next frame predicts from.

The JAX encoders search motion through the package's plain reference of
its Pallas kernel (``SELKIES_TPU_ME=scan``, same winners, tie rule
included); the Pallas kernel itself, in interpret mode, is held against
the port's motion search in tests/test_torch_h264_ops.py. On the CPU the
plain reference compiles in about half the time."""

import numpy as np
import pytest

pytest.importorskip("jax")

from selkies_tpu.encoder.h264 import H264StripeEncoder as JaxEncoder  # noqa: E402
from selkies_tpu_torch.encoder import device_cavlc as dcav  # noqa: E402
from selkies_tpu_torch.encoder.h264 import H264StripeEncoder  # noqa: E402
from selkies_tpu_torch.encoder.pipeline import PipelinedH264Encoder  # noqa: E402

W, H = 128, 96
KW = dict(stripe_height=32, paint_over_trigger_frames=2)


def _base(seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    base = np.stack([120 + 60 * np.sin(xx / 9.0) * np.cos(yy / 7.0),
                     110 + 60 * np.cos(xx / 11.0),
                     140 + 50 * np.sin(yy / 5.0)], -1)
    base[20:50, 30:90] = rng.integers(0, 256, (30, 60, 3))
    return np.clip(base, 0, 255).astype(np.uint8)


def _frames():
    """IDR, three rolled P frames, three static frames (the third paints
    over), then a keyframe request before frame 7 and one more P frame."""
    base = _base()
    rolled = [np.roll(base, 3 * k, axis=0) for k in range(4)]
    return rolled + [rolled[-1]] * 4 + [np.roll(base, 12, axis=0)]


KEYFRAME_AT = 7


@pytest.fixture(scope="module", autouse=True)
def _plain_reference_search():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SELKIES_TPU_ME", "scan")
        yield


def _jax_encoder(**kw):
    enc = JaxEncoder(W, H, **{**KW, **kw})
    # the fetch-prefix tier sets how many bytes are read, never the bytes
    # coded; one tier keeps the reference to one compiled program
    enc._prefix_small = enc._batch_prefix
    return enc


def _stripes(out):
    return [(s.y_start, s.width, s.height, s.is_key, s.annexb) for s in out]


@pytest.fixture(scope="module")
def runs():
    frames = _frames()
    jenc = _jax_encoder()
    tenc = H264StripeEncoder(W, H, device="cpu", **KW)
    want, got = [], []
    for k, f in enumerate(frames):
        if k == KEYFRAME_AT:
            jenc.request_keyframe()
            tenc.request_keyframe()
        want.append(_stripes(jenc.encode_frame(f)))
        got.append(_stripes(tenc.encode_frame(f)))
    return jenc, tenc, want, got


@pytest.mark.parametrize("k", range(len(_frames())))
def test_annexb_byte_identical_to_jax(runs, k):
    _, _, want, got = runs
    assert got[k] == want[k]


def test_sequence_covers_idr_p_paint_over_and_keyframe(runs):
    _, tenc, _, got = runs
    assert all(s[3] for s in got[0]) and len(got[0]) == 3       # IDR
    assert got[1] and not any(s[3] for s in got[1])             # P
    assert got[4] == [] and got[5] == []                         # static
    assert len(got[6]) == 3 and not any(s[3] for s in got[6])   # paint-over
    assert all(s[3] for s in got[KEYFRAME_AT])                   # requested
    assert tenc.entropy_errors_total == 0


def test_stripe_ref_equals_jax_reference_planes(runs):
    jenc, tenc, _, _ = runs
    for i in range(tenc.n_stripes):
        for a, b in zip(tenc.stripe_ref(i), jenc.stripe_ref(i)):
            assert np.array_equal(a, np.asarray(b))


def test_overflowed_stripe_is_host_coded_and_identical():
    """At QP 0 a flat red -> blue change drives the chroma DC levels past
    the CAVLC escape range: the device pack flags those stripes and the
    host coder codes them from the exact levels."""
    red = np.zeros((H, W, 3), np.uint8)
    red[..., 0] = 255
    blue = np.zeros((H, W, 3), np.uint8)
    blue[..., 2] = 255
    blue[:32] = red[:32]                          # stripe 0 stays static
    frames = [red, blue, blue]
    jenc = _jax_encoder(qp=0)
    tenc = H264StripeEncoder(W, H, device="cpu", qp=0, **KW)
    for f in frames:
        assert _stripes(tenc.encode_frame(f)) == \
            _stripes(jenc.encode_frame(f))
    assert tenc.host_coded_stripes_total == 2
    assert tenc.entropy_errors_total == 0


def test_pipelined_equals_synchronous():
    """Three frames in flight, heads fetched two at a time; the keyframe
    is requested once the first IDR has been harvested (a harvest of an
    IDR still in flight clears the request, in both packages)."""
    frames = _frames()[:4] + [np.roll(_base(), s, axis=0) for s in (12, 15)]
    sync = H264StripeEncoder(W, H, device="cpu", stripe_height=32)
    pipe = PipelinedH264Encoder(
        H264StripeEncoder(W, H, device="cpu", stripe_height=32),
        depth=3, fetch_group=2)
    want = []
    for k, f in enumerate(frames):
        if k == 4:
            sync.request_keyframe()
            pipe.request_keyframe()
        want.append(_stripes(sync.encode_frame(f)))
        pipe.submit(f)
    got = dict(pipe.flush())
    assert [_stripes(got[k]) for k in range(len(frames))] == want
    st = pipe.stats()
    assert st["frames"] == len(frames) and st["entropy_errors"] == 0
    assert st["d2h_bytes_per_frame"] > 0
    pipe.close()


def test_entropy_error_forces_idr_resync(monkeypatch):
    enc = H264StripeEncoder(W, H, device="cpu", stripe_height=32)
    base = _base()
    enc.encode_frame(base)
    calls = []
    real = dcav.assemble_p_slice

    def fails_once(*a, **kw):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("coder fault")
        return real(*a, **kw)

    monkeypatch.setattr(dcav, "assemble_p_slice", fails_once)
    out = enc.encode_frame(np.roll(base, 3, axis=0))
    assert enc.entropy_errors_total == 1 and len(out) == 2
    assert enc.stripes[0].need_idr
    out = enc.encode_frame(np.roll(base, 6, axis=0))
    assert [s.is_key for s in out] == [True] * 3


def test_bad_geometry_is_refused():
    with pytest.raises(ValueError):
        H264StripeEncoder(127, 96, device="cpu")
    with pytest.raises(ValueError):
        H264StripeEncoder(128, 96, stripe_height=24, device="cpu")

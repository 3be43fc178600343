"""The port's full-frame ``x264enc`` encoder against the JAX package's on
the CPU.

``fullframe=True`` codes one stripe over the whole frame (here 128x90,
padded to 96 rows, so the stripe holds replicate-padded rows and the SPS
crops them). Same frames in, same Annex-B bytes out (tolerance 0), with
device entropy and with host entropy: an IDR, rolled P frames, static
frames up to paint-over, a keyframe request and one more P frame; then a
noise frame at a low QP, whose levels overflow the host tier's cell budget
(count > cap) and are re-read exactly. The two entropy tiers of the port
give the same bytes too.

The JAX encoders search motion through the package's plain reference of
its Pallas kernel (``SELKIES_TPU_ME=scan``), as tests/test_torch_h264.py
does."""

import numpy as np
import pytest

pytest.importorskip("jax")

from selkies_tpu.encoder.h264 import H264StripeEncoder as JaxEncoder  # noqa: E402
from selkies_tpu_torch.encoder.h264 import H264StripeEncoder  # noqa: E402

W, H = 128, 90
KW = dict(fullframe=True, paint_over_trigger_frames=2)
KEYFRAME_AT = 7


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
    over), a keyframe request before frame 7, then one more P frame."""
    base = _base()
    rolled = [np.roll(base, 3 * k, axis=0) for k in range(4)]
    return rolled + [rolled[-1]] * 4 + [np.roll(base, 12, axis=0)]


def _noise_frames():
    """A frame, then noise over most of it: at QP 10 its P levels fill far
    more cells than the host tier's cap."""
    rng = np.random.default_rng(9)
    a = _base(1)
    b = a.copy()
    b[8:82, 8:120] = rng.integers(0, 256, (74, 112, 3), dtype=np.uint8)
    return [a, b, np.roll(b, 2, axis=1)]


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


def _run(jenc, tenc, frames, keyframe_at=None):
    want, got = [], []
    for k, f in enumerate(frames):
        if k == keyframe_at:
            jenc.request_keyframe()
            tenc.request_keyframe()
        want.append(_stripes(jenc.encode_frame(f)))
        got.append(_stripes(tenc.encode_frame(f)))
    return want, got


@pytest.fixture(scope="module", params=["device", "host"])
def runs(request):
    entropy = request.param
    jenc = _jax_encoder(entropy=entropy)
    tenc = H264StripeEncoder(W, H, device="cpu", entropy=entropy, **KW)
    want, got = _run(jenc, tenc, _frames(), KEYFRAME_AT)
    return entropy, tenc, want, got


@pytest.mark.parametrize("k", range(len(_frames())))
def test_fullframe_annexb_byte_identical_to_jax(runs, k):
    _, _, want, got = runs
    assert got[k] == want[k]


def test_one_stripe_covers_the_frame_and_the_sps_crops(runs):
    entropy, tenc, _, got = runs
    assert tenc.entropy == entropy
    assert tenc.n_stripes == 1 and tenc.stripe_h == 96 and tenc.pad_h == 96
    assert [(s[0], s[1], s[2]) for s in got[0]] == [(0, W, H)]
    assert got[0][0][3] and not got[1][0][3]                     # IDR, P
    assert got[4] == [] and got[5] == []                         # static
    assert len(got[6]) == 1 and not got[6][0][3]                 # paint-over
    assert got[KEYFRAME_AT][0][3]                                 # requested
    assert tenc.entropy_errors_total == 0


def test_noise_overflows_the_cell_cap_and_is_reread_exactly():
    """The host tier flags the stripe (nonzero cells > cap), re-reads its
    exact levels and codes them: the same bytes as the JAX package, and as
    the port's device tier."""
    frames = _noise_frames()
    jenc = _jax_encoder(entropy="host", qp=10)
    tenc = H264StripeEncoder(W, H, device="cpu", entropy="host", qp=10, **KW)
    want, got = _run(jenc, tenc, frames)
    assert got == want
    assert tenc.host_coded_stripes_total >= 1
    assert tenc.d2h_refetch_bytes_total >= 2 * tenc._stripe_words
    dev = H264StripeEncoder(W, H, device="cpu", entropy="device", qp=10,
                            **KW)
    assert [_stripes(dev.encode_frame(f)) for f in frames] == got


def test_device_and_host_entropy_give_identical_bytes():
    """The port's two tiers on one full-frame sequence (cf. the JAX
    package's tests/test_conformance.py, which holds the same for
    itself)."""
    frames = _frames()
    out = {}
    for entropy in ("device", "host"):
        enc = H264StripeEncoder(W, H, device="cpu", entropy=entropy, **KW)
        out[entropy] = []
        for k, f in enumerate(frames):
            if k == KEYFRAME_AT:
                enc.request_keyframe()
            out[entropy].append(_stripes(enc.encode_frame(f)))
    assert out["device"] == out["host"]


def test_fullframe_stripe_ref_equals_jax_reference_planes():
    jenc = _jax_encoder(entropy="device")
    tenc = H264StripeEncoder(W, H, device="cpu", entropy="device", **KW)
    _run(jenc, tenc, _frames()[:3])
    for a, b in zip(tenc.stripe_ref(0), jenc.stripe_ref(0)):
        assert a.shape[0] == 96 or a.shape[0] == 48
        assert np.array_equal(a, np.asarray(b))


def test_entropy_tier_from_environment(monkeypatch):
    monkeypatch.setenv("SELKIES_TPU_H264_ENTROPY", "host")
    assert H264StripeEncoder(W, H, device="cpu").entropy == "host"
    monkeypatch.delenv("SELKIES_TPU_H264_ENTROPY")
    assert H264StripeEncoder(W, H, device="cpu").entropy == "device"
    with pytest.raises(ValueError):
        H264StripeEncoder(W, H, device="cpu", entropy="gpu")

"""The host-entropy rung of both codecs in the port, against the JAX
package on the CPU, and the worker that serves it.

* H.264 ``entropy="host"``, striped: the same Annex-B bytes as the JAX
  package (tolerance 0) over an IDR, P, paint-over and keyframe sequence,
  and as the port's device tier;
* ``_pack_sparse``: the same buffer as the JAX function, byte for byte,
  with a stripe past the cell cap, a stripe with a level past the int8
  range, a stripe left out of the update, and one stripe of more than
  65,535 nonzero cells, whose u16 count wraps in both;
* JPEG ``entropy="host"``: the same stripes as the JAX host rung and as the
  port's own device rung;
* ``ThreadedEncoderAdapter`` keeps order, drops under overload and reports
  errors through ``on_error``.
"""

import threading
import time

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from selkies_tpu.capture.synthetic import SyntheticSource as JSource  # noqa: E402
from selkies_tpu.encoder import h264_device as jdev  # noqa: E402
from selkies_tpu.encoder.h264 import H264StripeEncoder as JaxEncoder  # noqa: E402
from selkies_tpu.encoder.jpeg import JpegStripeEncoder as JJpeg  # noqa: E402
from selkies_tpu_torch.encoder import h264_device as tdev  # noqa: E402
from selkies_tpu_torch.encoder.h264 import H264StripeEncoder  # noqa: E402
from selkies_tpu_torch.encoder.jpeg import JpegStripeEncoder  # noqa: E402
from selkies_tpu_torch.encoder.pipeline import ThreadedEncoderAdapter  # noqa: E402

W, H = 128, 96
KW = dict(stripe_height=32, paint_over_trigger_frames=2)
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


def _stripes(out):
    return [(s.y_start, s.width, s.height, s.is_key, s.annexb) for s in out]


@pytest.fixture(scope="module")
def h264_runs():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SELKIES_TPU_ME", "scan")
        jenc = JaxEncoder(W, H, entropy="host", **KW)
        jenc._prefix_small = jenc._batch_prefix    # one compiled program
        tenc = H264StripeEncoder(W, H, device="cpu", entropy="host", **KW)
        want, got = [], []
        for k, f in enumerate(_frames()):
            if k == KEYFRAME_AT:
                jenc.request_keyframe()
                tenc.request_keyframe()
            want.append(_stripes(jenc.encode_frame(f)))
            got.append(_stripes(tenc.encode_frame(f)))
    return tenc, want, got


@pytest.mark.parametrize("k", range(len(_frames())))
def test_striped_host_entropy_byte_identical_to_jax(h264_runs, k):
    _, want, got = h264_runs
    assert got[k] == want[k]


def test_striped_host_entropy_equals_device_entropy(h264_runs):
    tenc, _, got = h264_runs
    dev = H264StripeEncoder(W, H, device="cpu", entropy="device", **KW)
    out = []
    for k, f in enumerate(_frames()):
        if k == KEYFRAME_AT:
            dev.request_keyframe()
        out.append(_stripes(dev.encode_frame(f)))
    assert out == got
    assert len(got[6]) == 3 and all(s[3] for s in got[KEYFRAME_AT])
    assert tenc.entropy_errors_total == 0


def _sparse_case(seed):
    """flat16 [4, words]: stripe 0 sparse, stripe 1 dense (nonzero cells
    past the cap), stripe 2 sparse with one level past the int8 range,
    stripe 3 damaged but outside the update mask."""
    rng = np.random.default_rng(seed)
    S, words = 4, 2000
    flat = np.zeros((S, words), np.int16)
    for s, density in ((0, 0.003), (1, 0.6), (2, 0.003), (3, 0.05)):
        mask = rng.random(words) < density
        flat[s, mask] = rng.integers(-40, 41, mask.sum())
    flat[2, 777] = -300
    damage = np.array([True, True, False, True])
    update = np.array([True, True, True, False])
    return flat, damage, update


def _both_packs(flat, damage, update, cap_frac):
    want = np.asarray(jdev._pack_sparse(jnp.asarray(flat),
                                        jnp.asarray(damage),
                                        jnp.asarray(update),
                                        cap_frac=cap_frac))
    got = tdev._pack_sparse(torch.from_numpy(flat), torch.from_numpy(damage),
                            torch.from_numpy(update), cap_frac=cap_frac)
    return want, got.numpy()


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("cap_frac", [4, 8])
def test_pack_sparse_byte_identical_to_jax_with_overflow(seed, cap_frac):
    flat, damage, update = _sparse_case(seed)
    want, got = _both_packs(flat, damage, update, cap_frac)
    assert got.dtype == np.uint8 and np.array_equal(got, want)
    head = got[:16].reshape(4, 4)
    assert list(head[:, 3]) == [0, 1, 1, 0]          # overflow flags
    assert list(head[:, 2]) == [1, 1, 0, 1]          # damage
    assert head[3, 0] == head[3, 1] == 0             # not updated: no cells


def test_pack_sparse_u16_count_wraps_like_jax():
    """One stripe of 70,000 nonzero cells (a full-frame 1080p stripe has
    209,104 cells): the head keeps the count mod 65,536 and the overflow
    flag, in both packages."""
    n_cells = 70_000
    flat = np.zeros((1, n_cells * 16), np.int16)
    flat[0, ::16] = 1
    damage = update = np.array([True])
    want, got = _both_packs(flat, damage, update, 8)
    assert np.array_equal(got, want)
    count = int(got[0]) | (int(got[1]) << 8)
    assert count == n_cells % 65536 and got[3] == 1


def _jpeg_sequence():
    src = JSource(256, 120, pattern="desktop", seed=3)
    fr = [src.next_frame() for _ in range(3)]
    fr += [fr[-1]] * 4
    fr.append(np.random.default_rng(3).integers(0, 256, (120, 256, 3),
                                                dtype=np.uint8))
    return fr


def _jpeg_stripes(out):
    return [(s.y_start, s.is_paintover, s.jpeg) for s in out]


def test_jpeg_host_rung_equals_jax_host_rung_and_device_rung():
    kw = dict(stripe_height=64, paint_over_trigger_frames=2)
    jenc = JJpeg(256, 120, entropy="host", **kw)
    host = JpegStripeEncoder(256, 120, device="cpu", entropy="host", **kw)
    dev = JpegStripeEncoder(256, 120, device="cpu", **kw)
    emitted = 0
    for f in _jpeg_sequence():
        want = _jpeg_stripes(jenc.encode_frame(f))
        got = _jpeg_stripes(host.encode_frame(f))
        assert got == want
        assert _jpeg_stripes(dev.encode_frame(f)) == got
        emitted += len(got)
    assert emitted >= 7
    assert host.d2h_fetch_bytes_total > 0 and host.host_entropy_ms_total > 0
    with pytest.raises(ValueError):
        JpegStripeEncoder(256, 120, device="cpu", entropy="gpu")


class _SlowBase:
    """encode_frame sleeps until released, returns the frame's tag, and
    raises for a tag of -1."""

    def __init__(self):
        self.gate = threading.Event()
        self.entered = threading.Event()
        self.calls = []
        self.keyframes = 0

    def stream_context(self):
        import contextlib
        return contextlib.nullcontext()

    def encode_frame(self, frame):
        self.entered.set()
        self.gate.wait(10.0)
        tag = int(frame[0, 0, 0]) - 1
        self.calls.append(tag)
        if tag < 0:
            raise RuntimeError("coder fault")
        return [tag]

    #: the adapter's worker encodes a frame its submit already handed over
    _encode_frame = encode_frame

    def request_keyframe(self):
        self.keyframes += 1


def _tagged(tag):
    return np.full((2, 2, 3), tag + 1, np.uint8)


def test_adapter_keeps_order_and_drops_under_overload():
    base = _SlowBase()
    ad = ThreadedEncoderAdapter(base, depth=3)
    try:
        seqs = [ad.try_submit(_tagged(k)) for k in range(5)]
        assert seqs[:3] == [0, 1, 2] and seqs[3:] == [None, None]
        assert ad.stats()["frames_dropped"] == 2
        assert ad.poll() == []                       # nothing finished yet
        base.gate.set()
        out = ad.flush(10.0)
        assert out == [(0, [0]), (1, [1]), (2, [2])]
        assert ad.try_submit(_tagged(7)) == 3
        out = ad.flush(10.0)
        assert out == [(3, [7])] and base.calls == [0, 1, 2, 7]
        assert ad.pop_trace(3)["pack"][1] >= ad.pop_trace(2)["pack"][0]
        assert ad.pop_trace(3) is None
        ad.force_keyframe()
        assert base.keyframes == 1
        st = ad.stats()
        assert st["frames"] == 4 and st["encode_errors"] == 0
    finally:
        ad.close()
        assert ad.join(10.0)


def test_adapter_reports_errors_and_goes_on():
    base = _SlowBase()
    base.gate.set()
    ad = ThreadedEncoderAdapter(base, depth=3)
    errors = []
    ad.on_error = errors.append
    try:
        for tag in (0, -1, 2):
            ad.submit(_tagged(tag))
        out = ad.flush(10.0)
        assert out == [(0, [0]), (2, [2])]
        assert len(errors) == 1 and str(errors[0]) == "coder fault"
        assert ad.stats()["encode_errors"] == 1
    finally:
        ad.close()
        assert ad.join(10.0)
    assert ad.try_submit(_tagged(0)) is None         # closed


def test_adapter_close_never_blocks_on_a_running_encode():
    base = _SlowBase()
    ad = ThreadedEncoderAdapter(base, depth=3)
    ad.submit(_tagged(0))
    assert base.entered.wait(10.0)                   # frame 0 is encoding
    ad.submit(_tagged(1))
    t0 = time.monotonic()
    ad.close()
    assert time.monotonic() - t0 < 1.0
    base.gate.set()
    assert ad.join(10.0)
    assert base.calls == [0]                         # the queued one dropped


def test_adapter_serves_the_real_encoder_in_order():
    """The H.264 host rung behind the adapter equals its synchronous
    run."""
    frames = _frames()[:4]
    sync = H264StripeEncoder(W, H, device="cpu", entropy="host", **KW)
    want = [_stripes(sync.encode_frame(f)) for f in frames]
    ad = ThreadedEncoderAdapter(
        H264StripeEncoder(W, H, device="cpu", entropy="host", **KW), depth=8)
    try:
        for f in frames:
            ad.submit(f)
        got = ad.flush(60.0)
        assert [s for s, _ in got] == [0, 1, 2, 3]
        assert [_stripes(out) for _, out in got] == want
        st = ad.stats()
        assert st["entropy"] == "host" and st["d2h_bytes_per_frame"] > 0
        assert st["entropy_errors"] == 0
    finally:
        ad.close()
        assert ad.join(10.0)

"""The port's CUDA kernels and encoders on the card (skip without one).

These need a CUDA card: the hand-written kernels have no CPU mode. They import
no jax, so they run on the machine with the card as they are:

    python -m pytest tests/test_torch_cuda.py -m cuda -q

Each holds the card against the port's plain PyTorch version, which
tests/test_torch_ops.py and tests/test_torch_h264*.py hold equal to the
JAX package on the CPU.
"""

import gc

import numpy as np
import pytest
import torch

from selkies_tpu_torch._device import encoder_stream
from selkies_tpu_torch.capture.synthetic import (DeviceScrollSource,
                                                 SyntheticSource)
from selkies_tpu_torch.encoder.h264 import H264StripeEncoder
from selkies_tpu_torch.encoder.h264_device import _pack_sparse
from selkies_tpu_torch.encoder.jpeg import JpegStripeEncoder, _recip
from selkies_tpu_torch.encoder.async_driver import AsyncEncodeDriver
from selkies_tpu_torch.encoder.pipeline import (PipelinedH264Encoder,
                                                PipelinedJpegEncoder,
                                                ThreadedEncoderAdapter)
from selkies_tpu_torch.ops.dct_quant import (dct8_quant_zigzag,
                                             dct8_quant_zigzag_plain)
from selkies_tpu_torch.ops.me_mc import me_mc_stripes
from selkies_tpu_torch.ops.motion import full_search_mc
from selkies_tpu_torch.ops.quant import quality_scaled_tables

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _recips(q=40, pq=90):
    return _recip(np.stack([quality_scaled_tables(q)[0],
                            quality_scaled_tables(pq)[0]]))


@pytest.mark.parametrize("h,w", [(1088, 1920), (544, 960), (24, 40)])
def test_kernel_matches_plain(cuda_device, h, w):
    """The sm_90a kernel against its plain version on the card: max |diff|
    <= 1 and >= 99.9% equal (stated tolerance; both sum in one order, so
    in practice they agree exactly)."""
    rng = np.random.default_rng(h + w)
    plane = torch.from_numpy(
        rng.integers(0, 256, (h, w)).astype(np.float32)).to(cuda_device)
    recip = torch.from_numpy(_recips()).to(cuda_device)
    row = torch.from_numpy(
        (np.arange(h // 8) // 8 % 2).astype(np.int32)).to(cuda_device)
    before = dct8_quant_zigzag.launches
    (got,) = dct8_quant_zigzag([(plane, recip, row)])
    torch.cuda.synchronize()
    assert dct8_quant_zigzag.launches == before + 1
    want = dct8_quant_zigzag_plain(plane, recip, row)
    d = (got.int() - want.int()).abs()
    assert d.max().item() <= 1
    assert (d == 0).double().mean().item() >= 0.999


@pytest.mark.parametrize("h,w", [(1088, 1920), (48, 80)])
def test_frame_launch_matches_plain_per_plane(cuda_device, h, w):
    """Y (h, w) and Cb, Cr (h/2, w/2) in one launch, the chroma planes
    strided views of one buffer (no copy), against the plain version plane
    by plane: max |diff| <= 1 and >= 99.9% equal (stated tolerance; in
    practice exact)."""
    rng = np.random.default_rng(h * w)
    y = torch.from_numpy(
        rng.integers(0, 256, (h, w)).astype(np.float32)).to(cuda_device)
    both = torch.from_numpy(
        rng.integers(0, 256, (h // 2, w)).astype(np.float32)).to(cuda_device)
    cb, cr = both[:, :w // 2], both[:, w // 2:]
    assert not cb.is_contiguous()
    recip = torch.from_numpy(_recips()).to(cuda_device)
    row_y = torch.from_numpy(
        (np.arange(h // 8) // 8 % 2).astype(np.int32)).to(cuda_device)
    row_c = torch.from_numpy(
        (np.arange(h // 16) // 4 % 2).astype(np.int32)).to(cuda_device)
    planes = [(y, recip, row_y), (cb, recip, row_c), (cr, recip, row_c)]
    before = dct8_quant_zigzag.launches
    got = dct8_quant_zigzag(planes)
    torch.cuda.synchronize()
    assert dct8_quant_zigzag.launches == before + 1
    for g, p in zip(got, planes):
        want = dct8_quant_zigzag_plain(*p)
        assert g.shape == want.shape
        d = (g.int() - want.int()).abs()
        assert d.max().item() <= 1
        assert (d == 0).double().mean().item() >= 0.999


@pytest.mark.parametrize("w,h,pad", [(1366, 768, (768, 1376)),
                                     (2560, 1440, (1472, 2560))])
def test_frame_launch_at_resize_planes(cuda_device, w, h, pad):
    """A resized display's JPEG planes (the encoder's padding: 1366 wide
    pads to 1376, 1440 rows to 23 stripes of 64), made by the encoder's
    own color conversion on the card: one launch for Y, Cb and Cr, every
    coefficient equal to the plain version's (stated tolerance: exact)."""
    from selkies_tpu_torch.ops.color import rgb_to_ycbcr, subsample_420

    enc = JpegStripeEncoder(w, h, stripe_height=64, device=cuda_device)
    assert (enc.pad_h, enc.pad_w) == pad
    frame = SyntheticSource(w, h, pattern="desktop", seed=2).next_frame()
    y, cb, cr = rgb_to_ycbcr(torch.from_numpy(enc._pad(frame)).to(
        cuda_device))
    cb, cr = subsample_420(cb), subsample_420(cr)
    qsel = torch.arange(enc.n_stripes, device=cuda_device,
                        dtype=torch.int32) % 2
    row_y = qsel[torch.arange(y.shape[0] // 8, device=cuda_device) // 8]
    row_c = qsel[torch.arange(cb.shape[0] // 8, device=cuda_device) // 4]
    planes = [(y, enc._recip_y, row_y), (cb, enc._recip_c, row_c),
              (cr, enc._recip_c, row_c)]
    before = dct8_quant_zigzag.launches
    got = dct8_quant_zigzag(planes)
    torch.cuda.synchronize()
    assert dct8_quant_zigzag.launches == before + 1
    for g, p in zip(got, planes):
        assert torch.equal(g, dct8_quant_zigzag_plain(*p))


def test_kernel_rejects_what_it_does_not_take(cuda_device):
    recip = torch.from_numpy(_recips()).to(cuda_device)
    row = torch.zeros(2, dtype=torch.int32, device=cuda_device)
    with pytest.raises(TypeError):
        dct8_quant_zigzag([(torch.zeros(16, 16, dtype=torch.float64,
                                        device=cuda_device), recip, row)])
    with pytest.raises(ValueError):              # rows not 16-byte apart
        dct8_quant_zigzag([(torch.zeros(16, 34, device=cuda_device)[:, :16],
                            recip, row)])
    with pytest.raises(ValueError):              # columns strided
        dct8_quant_zigzag([(torch.zeros(16, 32, device=cuda_device)[:, ::2],
                            recip, row)])
    with pytest.raises(ValueError):
        dct8_quant_zigzag([(torch.zeros(16, 16, device=cuda_device),
                            recip.cpu(), row)])


def test_encoder_on_card_equals_cpu(cuda_device):
    """A short sequence with paint-over and a host-coded (overflowed) noise
    stripe: the card's stripes equal the CPU's byte for byte."""
    kw = dict(stripe_height=64, paintover_quality=100,
              paint_over_trigger_frames=2)
    w, h = 256, 120
    src = SyntheticSource(w, h, pattern="desktop", seed=3)
    frames = [src.next_frame() for _ in range(3)]
    frames += [frames[-1]] * 4
    frames.append(SyntheticSource(w, h, pattern="noise", seed=4).next_frame())
    frames += [frames[-1]] * 3
    cpu = JpegStripeEncoder(w, h, device="cpu", **kw)
    gpu = JpegStripeEncoder(w, h, device=cuda_device, **kw)
    for f in frames:
        a, b = cpu.encode_frame(f), gpu.encode_frame(f)
        assert [(s.y_start, s.is_paintover, s.jpeg) for s in a] == \
            [(s.y_start, s.is_paintover, s.jpeg) for s in b]
    assert gpu.host_fallback_stripes_total == cpu.host_fallback_stripes_total > 0


def _me_pair(kind, h=1088, w=1920):
    """(cur, ref) luma planes [h, w]: a scrolled desktop (true motion),
    noise, two flat frames of different levels (all offsets tie), a 4x4
    dot lattice moved by (1, 1) (many SAD-0 ties away from rank 0), and
    random texture moved by (5, 3) (true motion at any width)."""
    if kind == "shifted":
        big = np.random.default_rng(w).integers(0, 256, (h + 8, w + 8),
                                                dtype=np.uint8)
        return big[5:5 + h, 3:3 + w].copy(), big[:h, :w].copy()
    if kind in ("scroll", "noise"):
        src = SyntheticSource(w, h, pattern=kind, seed=5)
        a, b = src.next_frame()[..., 1], src.next_frame()[..., 1]
        return np.ascontiguousarray(a), np.ascontiguousarray(b)
    if kind == "flat":
        return np.full((h, w), 90, np.uint8), np.full((h, w), 100, np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    ref = np.where((yy % 4 == 0) & (xx % 4 == 0), 220, 30).astype(np.uint8)
    return np.roll(ref, (1, 1), axis=(0, 1)), ref


def _me_check(device, cur, ref, sh, search, seed=6):
    """me_mc_stripes on the card against full_search_mc (the plain
    version) on the same card tensors: every value exactly equal."""
    h, w = cur.shape
    S = h // sh
    rng = np.random.default_rng(seed)
    cb, cr = (rng.integers(0, 256, (S, sh // 2, w // 2), dtype=np.uint8)
              for _ in range(2))
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in (cur.reshape(S, sh, w), ref.reshape(S, sh, w), cb, cr)]
    before = me_mc_stripes.launches
    got = me_mc_stripes(*args, search=search)
    torch.cuda.synchronize()
    assert me_mc_stripes.launches == before + 1
    want = full_search_mc(*args, search=search)
    for g, w_ in zip(got, want):
        assert g.dtype == w_.dtype and g.shape == w_.shape
        assert torch.equal(g, w_)
    return got[0]


@pytest.mark.parametrize("kind", ["scroll", "noise", "flat", "lattice"])
def test_me_mc_kernel_equals_plain_at_1080p_stripes(cuda_device, kind):
    """17 stripes of 64x1920 at the served radius: mv and the three
    predictions exactly equal on true motion, noise and all-tie pairs."""
    cur, ref = _me_pair(kind)
    mv = _me_check(cuda_device, cur, ref, 64, 12)
    if kind == "flat":
        assert not mv.any()                      # every tie goes to (0, 0)
    if kind == "lattice":
        assert mv.any(-1).all()


@pytest.mark.parametrize("w", [1376, 1280, 48])
def test_me_mc_kernel_widths(cuda_device, w):
    """Widths whose MB count is not a multiple of the kernel's 8-MB run
    (1376: 86 MBs; 48: 3 MBs, one block at both stripe edges)."""
    for kind in ("shifted", "lattice"):
        cur, ref = _me_pair(kind, h=128, w=w)
        _me_check(cuda_device, cur, ref, 64, 12)


@pytest.mark.parametrize("w,h,shape", [(1366, 768, (12, 64, 1376)),
                                       (2560, 1440, (23, 64, 2560))])
def test_me_mc_kernel_at_resize_shapes(cuda_device, w, h, shape):
    """The stripes a resized x264enc-striped display hands the kernel (the
    encoder's own padding; 1376 is 10 whole 128-pixel tiles and a partial
    one of 6 MBs): every value exactly equal to the plain version's."""
    enc = H264StripeEncoder(w, h, stripe_height=64, device=cuda_device)
    assert (enc.n_stripes, enc.stripe_h, enc.pad_w) == shape
    for kind in ("shifted", "scroll", "lattice", "flat"):
        cur, ref = _me_pair(kind, h=shape[0] * 64, w=shape[2])
        _me_check(cuda_device, cur, ref, 64, 12)


@pytest.mark.parametrize("sh", [16, 32, 64])
def test_me_mc_kernel_stripe_heights(cuda_device, sh):
    cur, ref = _me_pair("scroll", h=192, w=640)
    _me_check(cuda_device, cur, ref, sh, 12)


@pytest.mark.parametrize("search", [0, 1, 7, 12, 15])
def test_me_mc_kernel_radii(cuda_device, search):
    """Every radius the kernel's launch shapes differ by (its dx groups of
    4, its dy chunks of 5): 0, 1, 7, 12, 15, on scroll and lattice."""
    for kind in ("scroll", "lattice"):
        cur, ref = _me_pair(kind, h=128, w=1376)
        _me_check(cuda_device, cur, ref, 32, search)


def test_me_mc_kernel_rejects_what_it_does_not_take(cuda_device):
    cur = torch.zeros((2, 32, 64), dtype=torch.uint8, device=cuda_device)
    cb = torch.zeros((2, 16, 32), dtype=torch.uint8, device=cuda_device)
    with pytest.raises(TypeError):
        me_mc_stripes(cur.int(), cur.int(), cb, cb)
    with pytest.raises(ValueError):
        me_mc_stripes(cur, cur, cb.cpu(), cb)
    strided = cur.transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError):
        me_mc_stripes(strided, cur, cb, cb)


def test_h264_encoder_on_card_equals_cpu(cuda_device):
    """IDR, scrolled P frames, static frames to paint-over and a keyframe
    request at 1920x256: the card's Annex-B stripes equal the CPU's."""
    src = SyntheticSource(1920, 256, pattern="scroll", seed=7)
    frames = [src.next_frame() for _ in range(4)]
    frames += [frames[-1]] * 4
    kw = dict(stripe_height=64, paint_over_trigger_frames=2)
    cpu = H264StripeEncoder(1920, 256, device="cpu", **kw)
    gpu = H264StripeEncoder(1920, 256, device=cuda_device, **kw)
    for k, f in enumerate(frames):
        if k == 6:
            cpu.request_keyframe()
            gpu.request_keyframe()
        a, b = cpu.encode_frame(f), gpu.encode_frame(f)
        assert [(s.y_start, s.is_key, s.annexb) for s in a] == \
            [(s.y_start, s.is_key, s.annexb) for s in b]
    assert gpu.entropy_errors_total == 0


def test_encoder_churn_keeps_reserved_memory_flat(cuda_device):
    """Encoders built, used and dropped in turn (displays joining and
    leaving) share the card's one stream, so the allocator reuses a
    dropped encoder's blocks. At 1280x720 each encoder holds allocations
    over 1 MB, which the allocator serves from 20 MB segments: with a
    stream per encoder the reserved memory grew by at least 20 MB a cycle
    (120 MB from the 2nd cycle to the 8th); the bound is 64 MB."""
    assert encoder_stream(cuda_device) is encoder_stream(cuda_device)
    src = SyntheticSource(1280, 720, pattern="scroll", seed=8)
    frames = [src.next_frame() for _ in range(3)]
    for make in (lambda: JpegStripeEncoder(1280, 720, device=cuda_device),
                 lambda: H264StripeEncoder(1280, 720, device=cuda_device)):
        readings = []
        for _ in range(8):
            enc = make()
            assert enc.stream is encoder_stream(cuda_device)
            for f in frames:
                enc.encode_frame(f)
            del enc
            gc.collect()
            torch.cuda.synchronize()
            readings.append(torch.cuda.memory_reserved())
        assert readings[-1] - readings[1] <= 64 << 20, readings


@pytest.mark.parametrize("kind", ["scroll", "noise", "flat", "lattice"])
def test_me_mc_kernel_full_frame_stripe(cuda_device, kind):
    """The x264enc profile's shape: one stripe over a whole 1280x720 frame
    (720 rows, not a multiple of 64; the window rows clamp to the frame),
    every value exactly equal to the plain version."""
    cur, ref = _me_pair(kind, h=720, w=1280)
    mv = _me_check(cuda_device, cur, ref, 720, 12)
    if kind == "flat":
        assert not mv.any()


def test_pack_sparse_on_card_equals_cpu(cuda_device):
    """The host tier's block-sparse pack (tensor code, a stable sort of
    an integer key among it) gives the CPU's bytes on the card: stripes
    sparse, dense past the cell cap, with a level past the int8 range and
    outside the update; and one stripe whose u16 count wraps."""
    rng = np.random.default_rng(12)
    flat = np.zeros((4, 393600), np.int16)
    for s, density in ((0, 0.001), (1, 0.5), (2, 0.002), (3, 0.01)):
        mask = rng.random(flat.shape[1]) < density
        flat[s, mask] = rng.integers(-60, 61, mask.sum())
    flat[2, 1234] = 500
    big = np.zeros((1, 70_000 * 16), np.int16)
    big[0, ::16] = -1
    cases = [(flat, [True, True, False, True], [True, True, True, False]),
             (big, [True], [True])]
    for levels, damage, update in cases:
        args = [torch.from_numpy(levels), torch.tensor(damage),
                torch.tensor(update)]
        want = _pack_sparse(*args, cap_frac=8)
        got = _pack_sparse(*(a.to(cuda_device) for a in args), cap_frac=8)
        assert torch.equal(got.cpu(), want)


def test_fullframe_and_host_entropy_on_card_equal_cpu(cuda_device):
    """x264enc (one stripe of 368 coded rows) with device and with host
    entropy, and x264enc-striped with host entropy, at 640x360: IDR,
    scrolled P frames, static frames to paint-over, a noise frame at QP 18
    (past the host tier's cell cap): the card's Annex-B equals the
    CPU's."""
    src = SyntheticSource(640, 360, pattern="scroll", seed=9)
    frames = [src.next_frame() for _ in range(3)]
    frames += [frames[-1]] * 3
    frames.append(SyntheticSource(640, 360, pattern="noise",
                                  seed=2).next_frame())
    for kw in (dict(fullframe=True, entropy="device"),
               dict(fullframe=True, entropy="host"),
               dict(stripe_height=64, entropy="host")):
        cpu = H264StripeEncoder(640, 360, device="cpu", qp=18,
                                paint_over_trigger_frames=2, **kw)
        gpu = H264StripeEncoder(640, 360, device=cuda_device, qp=18,
                                paint_over_trigger_frames=2, **kw)
        for f in frames:
            a, b = cpu.encode_frame(f), gpu.encode_frame(f)
            assert [(s.y_start, s.is_key, s.annexb) for s in a] == \
                [(s.y_start, s.is_key, s.annexb) for s in b], kw
        assert gpu.entropy_errors_total == 0
        assert gpu.host_coded_stripes_total == cpu.host_coded_stripes_total


def test_threaded_adapter_stays_on_the_encoder_stream(cuda_device):
    """The host rungs behind ThreadedEncoderAdapter: its worker thread
    runs the encoder inside the encoder's stream context, so its
    allocations land on the card's one encoder stream and a closed
    adapter's blocks are reused. Four build/encode/close cycles per codec
    at 1280x720: the reserved memory after the 4th is at most 64 MB above
    the 2nd's."""
    src = SyntheticSource(1280, 720, pattern="scroll", seed=10)
    frames = [src.next_frame() for _ in range(3)]
    for make in (lambda: JpegStripeEncoder(1280, 720, entropy="host",
                                           device=cuda_device),
                 lambda: H264StripeEncoder(1280, 720, entropy="host",
                                           device=cuda_device)):
        readings = []
        for _ in range(4):
            ad = ThreadedEncoderAdapter(make(), depth=3)
            assert ad.base.stream is encoder_stream(cuda_device)
            for f in frames:
                ad.submit(f)
            out = ad.flush(120.0)
            assert len(out) == 3 and ad.stats()["encode_errors"] == 0
            ad.close()
            assert ad.join(30.0)
            del ad, out
            gc.collect()
            torch.cuda.synchronize()
            readings.append(torch.cuda.memory_reserved())
        assert readings[-1] - readings[1] <= 64 << 20, readings


def _annexb(out):
    return [(s.y_start, s.is_key, s.annexb) for s in out]


def _batched(pipe, frames, B):
    got = {}
    for i in range(0, len(frames), B):
        chunk = frames[i:i + B]
        if len(chunk) == B:
            pipe.submit_batch(np.stack(chunk))
        else:
            for f in chunk:
                pipe.submit(f)
        got.update(pipe.flush())
    return [_annexb(got[k]) for k in range(len(frames))]


@pytest.mark.parametrize("entropy", ["device", "host"])
@pytest.mark.parametrize("profile", ["x264enc-striped", "x264enc"])
def test_batched_on_card_equals_cpu(cuda_device, profile, entropy):
    """B = 4 frames per dispatch at 640x360 (the IDR batch, motion, static
    frames whose paint-over falls inside a batch, more motion, a partial
    batch): the card's Annex-B equals the CPU's, whose bytes the CPU tests
    hold equal to the JAX package's and to one frame per dispatch."""
    B = 4
    src = SyntheticSource(640, 360, pattern="scroll", seed=9)
    moving = [src.next_frame() for _ in range(B + 2)]
    frames = moving + [moving[-1]] * (2 * B - 2) \
        + [src.next_frame() for _ in range(2 * B - 1)]
    geo = dict(fullframe=True) if profile == "x264enc" else \
        dict(stripe_height=64)
    kw = dict(paint_over_trigger_frames=B, entropy=entropy, **geo)
    out = {}
    for dev in ("cpu", cuda_device):
        pipe = PipelinedH264Encoder(H264StripeEncoder(640, 360, device=dev,
                                                      **kw),
                                    depth=4 * B, batch=B)
        out[str(dev)] = _batched(pipe, frames, B)
        assert pipe.stats()["entropy_errors"] == 0
    assert out[str(cuda_device)] == out["cpu"]
    assert any(s for s in out["cpu"][2 * B + 2])          # the paint-over


def test_device_scroll_source_on_card_equals_cpu(cuda_device):
    """Frames and batches made on the card equal those made on the CPU,
    past the wrap-around."""
    gpu = DeviceScrollSource(640, 64, seed=3, device=cuda_device)
    cpu = DeviceScrollSource(640, 64, seed=3, device="cpu")
    for _ in range(20):
        assert torch.equal(gpu.next_frame().cpu(), cpu.next_frame())
    for n in (5, 12):
        b = gpu.next_batch(n)
        assert b.device.type == "cuda"
        assert torch.equal(b.cpu(), cpu.next_batch(n))


@pytest.mark.parametrize("path", ["jpeg", "h264", "h264-batch", "driver"])
def test_frame_written_on_a_side_stream(cuda_device, path):
    """A frame made on another stream than the encoder's: the caller's
    stream is held up (a sleep kernel) before the frame is written, the
    caller drops the frame right after submitting it and writes a block
    of the same size over and over on its stream. The encoder stream
    waits for the caller's stream at the hand-over, and the frame's block
    is not reused before the encoder has read it (record_stream), so the
    bytes are those of the true frames, encoded on the CPU."""
    w, h = 640, 384
    n = 8
    if path == "jpeg":
        def make(dev):
            return PipelinedJpegEncoder(JpegStripeEncoder(
                w, h, stripe_height=64, device=dev), depth=4)
        key = (lambda out: [(s.y_start, s.jpeg) for s in out])
    else:
        def make(dev):
            return PipelinedH264Encoder(
                H264StripeEncoder(w, h, stripe_height=64, device=dev),
                depth=8, batch=4 if path == "h264-batch" else 1)
        key = _annexb
    want_pipe = make("cpu")
    host_src = DeviceScrollSource(w, h, seed=6, device="cpu")
    for _ in range(n):
        want_pipe.submit(host_src.next_frame().numpy())
    want = dict(want_pipe.flush())

    pipe = make(cuda_device)
    drv = AsyncEncodeDriver(pipe) if path == "driver" else None
    side = torch.cuda.Stream()
    assert side != pipe.base.stream
    src = DeviceScrollSource(w, h, seed=6, device=cuda_device)
    got = {}
    with torch.cuda.stream(side):
        for _ in range(n):
            torch.cuda._sleep(20_000_000)
            frame = torch.empty((h, w, 3), dtype=torch.uint8,
                                device=cuda_device)
            frame.copy_(src.next_frame())
            if drv is not None:
                assert drv.try_submit(frame) is not None
            else:
                pipe.submit(frame)
            del frame
            for _ in range(4):
                torch.full((h, w, 3), 255, dtype=torch.uint8,
                           device=cuda_device)
    if drv is not None:
        got.update(drv.flush(120.0))
        drv.close()
        assert drv.join(30.0)
    else:
        got.update(pipe.flush())
    assert sorted(got) == list(range(n))
    for k in range(n):
        assert key(got[k]) == key(want[k]), f"frame {k}"


LADDER_W, LADDER_H = 640, 360


def _ladder_settings(**env):
    from selkies_tpu_torch.settings import Settings

    return Settings(argv=[], env=dict({
        "SELKIES_PORT": "0", "SELKIES_ENCODER": "x264enc-striped",
        "SELKIES_LADDER_FAIL_THRESHOLD": "3",
        "SELKIES_SUPERVISOR_MAX_RESTARTS": "50"}, **env))


def test_display_walks_the_ladder_on_the_card(cuda_device):
    """A served 640x360 x264enc-striped display on the card, every frame
    ACKed: encode.raise*3 steps it device -> host (0x04, me_mc launches),
    three more host -> jpeg (0x03, dct8 launches), and a clean window
    probes it back up through host to device (0x04 again); the first frame
    after every restart is an IDR or a JPEG."""
    import asyncio
    import json
    import time

    from selkies_tpu_torch.protocol.wire import unpack_binary
    from selkies_tpu_torch.robustness import InProcessClient
    from selkies_tpu_torch.server.data_server import DataStreamingServer

    from selkies_tpu_torch import _build
    from selkies_tpu_torch.native import cavlc_lib, entropy_lib

    # every rung's kernels and host coders built first, as the entry
    # point's warm-up does: a rung whose first frame waits for a build
    # still submits (clean ticks), so the 4 s probe could step it back up
    # before it sent a frame
    for stem in ("me_mc", "dct_quant"):
        _build.load_library(stem)
    cavlc_lib()
    entropy_lib()

    async def run():
        server = DataStreamingServer(
            _ladder_settings(SELKIES_LADDER_PROBE_MS="4000"),
            device=cuda_device)
        ws = InProcessClient()
        task = asyncio.create_task(server.ws_handler(ws))
        ws.feed("SETTINGS," + json.dumps({
            "displayId": "primary", "initialClientWidth": LADDER_W,
            "initialClientHeight": LADDER_H, "framerate": 60}))
        seen = {"n": 0, "rung": "device", "fresh": False, "id": None}
        types = {"device": set(), "host": set(), "jpeg": set()}
        launches = {"device": [0, 0], "host": [0, 0], "jpeg": [0, 0]}
        last = [me_mc_stripes.launches, dct8_quant_zigzag.launches]

        async def until(pred, timeout=120.0):
            deadline = time.monotonic() + timeout
            while not pred():
                assert time.monotonic() < deadline, (seen, types)
                await asyncio.sleep(0.005)
                st = server.display_clients["primary"]
                now = [me_mc_stripes.launches, dct8_quant_zigzag.launches]
                for k in (0, 1):
                    launches[st.ladder.rung][k] += now[k] - last[k]
                last[:] = now
                for m in ws.sent[seen["n"]:]:
                    if isinstance(m, str):
                        if m.startswith("PIPELINE_RESETTING"):
                            seen["fresh"], seen["id"] = True, None
                        elif '"system_health"' in m:
                            seen["rung"] = json.loads(m)["displays"][
                                "primary"]["rung"]
                        continue
                    f = unpack_binary(bytes(m))
                    types[seen["rung"]].add(m[0])
                    if f.frame_id != seen["id"]:
                        if seen["fresh"]:
                            assert m[0] == 0x03 or m[1] == 1
                            seen["fresh"] = False
                        seen["id"] = f.frame_id
                        ws.feed(f"CLIENT_FRAME_ACK {f.frame_id}")
                seen["n"] = len(ws.sent)

        await until(lambda: types["device"])
        st = server.display_clients["primary"]
        server.faults.arm_spec("encode.raise*3")
        await until(lambda: st.ladder.transitions and types["host"])
        server.faults.arm_spec("encode.raise*3")
        await until(lambda: len(st.ladder.transitions) >= 2
                    and types["jpeg"])
        types["device"].clear()            # frames after the probes
        await until(lambda: len(st.ladder.transitions) == 4
                    and types["device"])
        transitions = list(st.ladder.transitions)
        await ws.close()
        await asyncio.wait_for(task, 30.0)
        await server.stop()
        return transitions, types, launches

    transitions, types, launches = asyncio.run(run())
    assert transitions == ["device->host", "host->jpeg", "jpeg->host",
                           "host->device"]
    assert types == {"device": {0x04}, "host": {0x04}, "jpeg": {0x03}}
    assert launches["device"][0] > 0 and launches["host"][0] > 0
    assert launches["jpeg"][1] > 0


def test_first_frame_at_each_rung_equals_cpu(cuda_device):
    """For each rung of an x264enc-striped display at 640x360, the encoder
    the server builds there (the factory with the rung's overrides) gives
    the same first-frame wire messages on the card as on the CPU: an IDR
    at device and host, JPEG stripes at jpeg."""
    from selkies_tpu_torch.robustness import RUNGS
    from selkies_tpu_torch.server.data_server import (_pack_stripe,
                                                      default_encoder_factory,
                                                      rung_overrides)

    settings = _ladder_settings()
    frame = SyntheticSource(LADDER_W, LADDER_H, pattern="desktop",
                            seed=5).next_frame()
    for rung in RUNGS:
        got = []
        for dev in ("cpu", cuda_device):
            enc = default_encoder_factory(LADDER_W, LADDER_H, settings,
                                          rung_overrides({}, rung),
                                          device=dev)
            enc.submit(frame)
            (_, stripes), = enc.flush(120.0)
            got.append([_pack_stripe(1, s, enc) for s in stripes])
            assert enc.stats()["encode_errors"] == 0
            enc.close()
            assert enc.join(30.0)
        assert got[0] == got[1], rung
        assert got[1] and all(m[0] == (0x03 if rung == "jpeg" else 0x04)
                              for m in got[1])
        if rung != "jpeg":
            assert all(m[1] == 1 for m in got[1])          # IDR


LANE_W, LANE_H, LANE_N = 256, 128, 4


def _lane(kind, device):
    from selkies_tpu_torch.parallel.mesh import MeshStripeEncoder, Mesh
    from selkies_tpu_torch.parallel.mesh_h264 import MeshH264Encoder

    mesh = Mesh([[torch.device(device)]])
    kw = dict(stripe_h=32, paint_over_trigger_frames=2)
    if kind == "jpeg":
        return MeshStripeEncoder(mesh, LANE_N, LANE_W, LANE_H, **kw)
    return MeshH264Encoder(mesh, LANE_N, LANE_W, LANE_H,
                           entropy=kind.split("-")[1], **kw)


def _lane_script():
    """Per tick: each session's frame (None: idle) and the controls before
    it — a join, motion, an idle slot with a keyframe request, the
    keyframe, a reset slot, static ticks to paint-over."""
    src = [SyntheticSource(LANE_W, LANE_H, pattern="scroll", seed=10 + n)
           for n in range(LANE_N)]
    seq = [[s.next_frame() for s in src] for _ in range(4)]
    fresh = SyntheticSource(LANE_W, LANE_H, pattern="desktop",
                            seed=3).next_frame()
    return [((), seq[0]), ((), seq[1]),
            ((("force_keyframe", 2),), [seq[2][0], seq[2][1], None,
                                        seq[2][3]]),
            ((), [seq[2][0], seq[2][1], seq[1][2], seq[2][3]]),
            ((("reset_session", 1),), [seq[3][0], fresh, seq[1][2],
                                       seq[3][3]]),
            ((), [seq[3][0], fresh, seq[1][2], None]),
            ((), [seq[3][0], fresh, seq[1][2], seq[3][3]]),
            ((), [seq[3][0], fresh, seq[1][2], seq[3][3]])]


def _lane_bytes(out):
    return [[(s.y_start, getattr(s, "is_key", None),
              getattr(s, "annexb", None) or s.jpeg) for s in sess]
            for sess in out]


def _lane_drive(lane, window):
    """The script's ticks through ``lane`` with up to ``window`` dispatched
    ticks in flight (the scheduler's window), harvested in order. The
    paint-over history advances at harvest, so a window of 2 decides
    paint-over a tick later than one tick at a time: compare runs made
    with the same window."""
    out, inflight = [], []
    for ctl, frames in _lane_script():
        for name, arg in ctl:
            getattr(lane, name)(arg)
        inflight.append(lane.dispatch(frames))
        if len(inflight) == window:
            out.append(lane.harvest(inflight.pop(0)))
    return out + [lane.harvest(p) for p in inflight]


@pytest.mark.parametrize("window", [1, 2])
@pytest.mark.parametrize("kind", ["jpeg", "h264-device", "h264-host"])
def test_lane_on_card_equals_cpu(cuda_device, kind, window):
    """A 4-session lane at 256x128 (its idle slot, keyframe request, reset
    and paint-over included): every session's bytes on the card equal the
    same lane's on the CPU, tick by tick, one tick at a time and with two
    ticks in flight."""
    want = _lane_drive(_lane(kind, "cpu"), window)
    got = _lane_drive(_lane(kind, cuda_device), window)
    for k, ((wo, wb), (go, gb)) in enumerate(zip(want, got)):
        assert _lane_bytes(go) == _lane_bytes(wo), k
        assert list(gb) == list(wb), k
    assert len(got) == len(_lane_script())
    assert any(any(sess) for out, _ in got for sess in out)


@pytest.mark.parametrize("kind", ["jpeg", "h264-device", "h264-host"])
def test_lane_tick_launches_each_kernel_once(cuda_device, kind):
    """One lane tick over every session: one DCT+quant launch (JPEG) or
    one motion-search launch (H.264), whatever the number of sessions."""
    lane = _lane(kind, cuda_device)
    counter = dct8_quant_zigzag if kind == "jpeg" else me_mc_stripes
    other = me_mc_stripes if kind == "jpeg" else dct8_quant_zigzag
    c0, o0 = counter.launches, other.launches
    for ctl, frames in _lane_script():
        lane.encode_frames(frames)
    assert counter.launches - c0 == len(_lane_script())
    assert other.launches == o0


def test_lane_takes_frames_made_on_the_card(cuda_device):
    """Per-slot frame tensors (DeviceScrollSource, whose 128 rows are the
    padded height) and a stacked device batch go in without an upload;
    their bytes equal the same frames from the host."""
    from selkies_tpu_torch.parallel.mesh import Mesh
    from selkies_tpu_torch.parallel.mesh_h264 import MeshH264Encoder

    mesh = Mesh([[cuda_device]])
    src = [DeviceScrollSource(LANE_W, LANE_H, seed=n, device=cuda_device)
           for n in range(LANE_N)]
    a = MeshH264Encoder(mesh, LANE_N, LANE_W, LANE_H, stripe_h=32)
    b = MeshH264Encoder(mesh, LANE_N, LANE_W, LANE_H, stripe_h=32)
    for k in range(4):
        frames = [s.next_frame() for s in src]
        if k == 1:
            frames[3] = None
        # a stacked batch is not kept for re-presenting (as in the JAX
        # lane), so it comes last
        fa = torch.stack(frames) if k == 3 else frames
        oa, _ = a.encode_frames(fa)
        ob, _ = b.encode_frames([None if f is None else f.cpu().numpy()
                                 for f in frames])
        assert _lane_bytes(oa) == _lane_bytes(ob), k
    assert a.h2d_bytes_total == 0 and b.h2d_bytes_total > 0


def _served_spans(device, profile, frames=30, w=640, h=360):
    """One display of ``profile`` served on ``device`` through ws_handler,
    every frame ACKed until ``frames`` are; returns the recorder after
    the server stopped."""
    import asyncio
    import json
    import time

    from selkies_tpu_torch.protocol.wire import unpack_binary
    from selkies_tpu_torch.robustness import InProcessClient
    from selkies_tpu_torch.server.data_server import DataStreamingServer
    from selkies_tpu_torch.settings import Settings

    async def run():
        server = DataStreamingServer(
            Settings(argv=[], env={"SELKIES_PORT": "0",
                                   "SELKIES_ENCODER": profile}),
            device=device)
        ws = InProcessClient()
        task = asyncio.create_task(server.ws_handler(ws))
        ws.feed("SETTINGS," + json.dumps({
            "displayId": "primary", "initialClientWidth": w,
            "initialClientHeight": h, "framerate": 60}))
        acked, seen = set(), 0
        deadline = time.monotonic() + 120.0
        while len(acked) < frames:
            assert time.monotonic() < deadline, len(acked)
            await asyncio.sleep(0.002)
            for m in ws.sent[seen:]:
                if isinstance(m, (bytes, bytearray)):
                    fid = unpack_binary(bytes(m)).frame_id
                    if fid not in acked:
                        acked.add(fid)
                        ws.feed(f"CLIENT_FRAME_ACK {fid}")
            seen = len(ws.sent)
        await asyncio.sleep(0.1)
        await ws.close()
        await asyncio.wait_for(task, 30.0)
        await server.stop()
        return server.recorder

    return asyncio.run(run())


@pytest.mark.parametrize("profile", ["jpeg", "x264enc-striped"])
def test_served_display_on_card_closes_every_span_acked(cuda_device,
                                                        profile):
    """A served display on the card: every span closes (none open after
    stop), the ACKed ones carry every stage of the solo path, and the
    device wait shows in ``fetch_wait`` (> 0 on at least one frame)."""
    rec = _served_spans(cuda_device, profile)
    assert rec.open_spans() == 0
    acked = [t for t in rec._completed() if t.terminal == "acked"]
    assert len(acked) >= 30
    for t in acked:
        assert {"capture", "stage", "dispatch", "fetch_wait", "pack",
                "queue", "send", "ack"} <= set(t.spans), sorted(t.spans)
    assert any(t.duration_ms("fetch_wait") > 0 for t in acked)


def test_profiler_route_capture_holds_a_kernel_event(cuda_device):
    """The trace route's torch.profiler capture, requested over HTTP (the
    endpoint's own thread starts it), records the card: a kernel launched
    while it runs is a device event of the trace it writes."""
    import json
    import threading
    import time
    import urllib.request

    from selkies_tpu_torch.observability import Metrics

    plane = torch.rand(1088, 1920, device=cuda_device) * 255
    recip = torch.from_numpy(_recips()).to(cuda_device)
    row = torch.zeros(1088 // 8, dtype=torch.int32, device=cuda_device)
    m = Metrics(port=0)
    m.jax_trace_enabled = True
    assert m.start_http()
    stop = threading.Event()

    def launch():
        while not stop.is_set():
            dct8_quant_zigzag([(plane, recip, row)])
            torch.cuda.synchronize()
            time.sleep(0.005)

    th = threading.Thread(target=launch)
    th.start()
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{m.http_port}/debug/jax-trace?ms=300",
                timeout=60) as r:
            info = json.loads(r.read())
    finally:
        stop.set()
        th.join()
        m.stop_http()
    assert info["cuda"] and info["device_events"] > 0
    with open(info["path"]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("cat") == "kernel"
               and "dct8_quant_zigzag_kernel" in e.get("name", "")
               for e in events)

"""The port's CUDA kernels and encoders on the card (skip without one).

These need a CUDA card: the hand-written kernels have no CPU mode. They import
no jax, so they run on the machine with the card as they are:

    python -m pytest tests/test_torch_cuda.py -m cuda -q

Each holds the card against the port's plain PyTorch version, which
tests/test_torch_ops.py and tests/test_torch_h264*.py hold equal to the
JAX package on the CPU.
"""

import numpy as np
import pytest
import torch

from selkies_tpu_torch.capture.synthetic import SyntheticSource
from selkies_tpu_torch.encoder.h264 import H264StripeEncoder
from selkies_tpu_torch.encoder.jpeg import JpegStripeEncoder, _recip
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
    got = dct8_quant_zigzag(plane, recip, row)
    torch.cuda.synchronize()
    assert dct8_quant_zigzag.launches == before + 1
    want = dct8_quant_zigzag_plain(plane, recip, row)
    d = (got.int() - want.int()).abs()
    assert d.max().item() <= 1
    assert (d == 0).double().mean().item() >= 0.999


def test_kernel_rejects_what_it_does_not_take(cuda_device):
    recip = torch.from_numpy(_recips()).to(cuda_device)
    row = torch.zeros(2, dtype=torch.int32, device=cuda_device)
    with pytest.raises(TypeError):
        dct8_quant_zigzag(torch.zeros(16, 16, dtype=torch.float64,
                                      device=cuda_device), recip, row)
    with pytest.raises(ValueError):
        dct8_quant_zigzag(torch.zeros(16, 32, device=cuda_device)[:, :16],
                          recip, row)
    with pytest.raises(ValueError):
        dct8_quant_zigzag(torch.zeros(16, 16, device=cuda_device),
                          recip.cpu(), row)


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


@pytest.mark.parametrize("kind", ["scroll", "noise"])
def test_me_mc_kernel_equals_plain_at_1080p_stripes(cuda_device, kind):
    """17 stripes of 64x1920: true motion (a scrolled desktop) and noise
    (ties everywhere); mv and the three predictions exactly equal."""
    src = SyntheticSource(1920, 1088, pattern=kind, seed=5)
    a, b = src.next_frame()[..., 1], src.next_frame()[..., 1]
    rng = np.random.default_rng(6)
    cur = torch.from_numpy(np.ascontiguousarray(a).reshape(17, 64, 1920))
    ref = torch.from_numpy(np.ascontiguousarray(b).reshape(17, 64, 1920))
    cb, cr = (torch.from_numpy(rng.integers(0, 256, (17, 32, 960),
                                            dtype=np.uint8))
              for _ in range(2))
    args = [t.to(cuda_device) for t in (cur, ref, cb, cr)]
    before = me_mc_stripes.launches
    got = me_mc_stripes(*args)
    torch.cuda.synchronize()
    assert me_mc_stripes.launches == before + 1
    want = full_search_mc(*args)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


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

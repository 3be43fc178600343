"""The port's CUDA kernel and encoder on the card (skip without one).

These need a CUDA card: the hand-written kernel has no CPU mode. They import
no jax, so they run on the machine with the card as they are:

    python -m pytest tests/test_torch_cuda.py -m cuda -q

Each holds the card against the port's plain PyTorch version, which
tests/test_torch_ops.py holds equal to the JAX package on the CPU.
"""

import numpy as np
import pytest
import torch

from selkies_tpu_torch.capture.synthetic import SyntheticSource
from selkies_tpu_torch.encoder.jpeg import JpegStripeEncoder, _recip
from selkies_tpu_torch.ops.dct_quant import (dct8_quant_zigzag,
                                             dct8_quant_zigzag_plain)
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

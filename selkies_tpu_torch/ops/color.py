"""Color-space transforms (counterpart of ``selkies_tpu/ops/color.py``).

JFIF/BT.601 full-range coefficients, the convention libjpeg-class decoders
and the browser ``ImageDecoder`` assume. Written in the same elementwise
multiply-add form and the same coefficient order as the JAX package, so
the f32 results agree bit for bit on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

# Rows: Y, Cb, Cr; columns: R, G, B.
_RGB2YCC = np.array(
    [
        [0.299, 0.587, 0.114],
        [-0.168736, -0.331264, 0.5],
        [0.5, -0.418688, -0.081312],
    ],
    dtype=np.float32,
)


_coeffs = {}


def _rgb2ycc(device: torch.device) -> torch.Tensor:
    """The coefficient matrix on ``device``, uploaded once (a per-frame
    upload from pageable memory would synchronize the stream)."""
    m = _coeffs.get(device)
    if m is None:
        m = torch.from_numpy(_RGB2YCC).to(device)
        _coeffs[device] = m
    return m


def rgb_to_ycbcr(rgb: torch.Tensor):
    """[..., H, W, 3] uint8/float RGB → (Y, Cb, Cr) float32 planes [..., H, W].

    Values are in [0, 255]; no level shift here (the DCT stage subtracts
    128).
    """
    x = rgb.to(torch.float32)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    m = _rgb2ycc(x.device)
    y = m[0, 0] * r + m[0, 1] * g + m[0, 2] * b
    cb = m[1, 0] * r + m[1, 1] * g + m[1, 2] * b + 128.0
    cr = m[2, 0] * r + m[2, 1] * g + m[2, 2] * b + 128.0
    return y, cb, cr


def rgb_to_ycbcr_fused(rgb: torch.Tensor):
    """[..., H, W, 3] uint8 RGB -> (Y, Cb, Cr) float32, with the
    multiply-adds fused as XLA:CPU's jit fuses them in the JAX package's
    compiled steps: ``fma(m2, b, fma(m0, r, m1 * g)) + offset``, each fused
    multiply-add rounded once to float32.

    The H.264 profile rounds these planes to integers, where a last-bit
    difference shows, so it takes this form to equal the JAX encoder byte
    for byte. Each step is exact in float64 (an 8-bit integer times a
    float32 coefficient, plus a float32 below 512, needs under 40 bits), so
    one rounding to float32 after it is the fused operation's result, on
    the CPU and on the card alike."""
    x = rgb.to(torch.float64)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    m = _rgb2ycc(x.device).to(torch.float64)

    def f32(v):
        return v.to(torch.float32).to(torch.float64)

    out = []
    for i, off in enumerate((0.0, 128.0, 128.0)):
        acc = f32(m[i, 0] * r + f32(m[i, 1] * g))
        acc = f32(m[i, 2] * b + acc)
        out.append((acc + off).to(torch.float32))
    return tuple(out)


def subsample_420(plane: torch.Tensor) -> torch.Tensor:
    """2x2 mean-pool chroma subsampling: [..., H, W] → [..., H/2, W/2].

    Summed in one fixed order, (row-0 pair) + (row-1 pair), then / 4 — the
    order XLA:CPU's mean uses — so the CPU and the card (whose reductions
    may otherwise sum in another order) give the same f32 bits."""
    h, w = plane.shape[-2], plane.shape[-1]
    p = plane.reshape(*plane.shape[:-2], h // 2, 2, w // 2, 2)
    top = p[..., 0, :, 0] + p[..., 0, :, 1]
    bottom = p[..., 1, :, 0] + p[..., 1, :, 1]
    return (top + bottom) / 4.0

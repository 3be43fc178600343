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

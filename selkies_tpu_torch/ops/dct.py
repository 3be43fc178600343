"""Blocked 8x8 DCT-II, plain PyTorch (counterpart of ``selkies_tpu/ops/dct.py``).

The served path on the card does not run this: its DCT is the hand-written
kernel in ``csrc/dct_quant.cu`` (ops/dct_quant.py). This module holds the
DCT matrix both use, the block layout helpers, and the plain ``C·X·Cᵀ``
the kernel is held against.

Summation order. The JAX step's ``einsum`` becomes two f32 dots with a
contraction of 8 on XLA:CPU, which sums each 8-term dot product as four
interleaved fused-multiply-add chains (terms j and j+4) added as a tree,
``(acc0 + acc1) + (acc2 + acc3)``. :func:`block_dct2` sums in exactly that
order, with each FMA computed in f64 (the f32 product is exact there)
and rounded once to f32, so the port's coefficients equal the JAX step's
bit for bit on the CPU — including at quality 100, where the quantizer
step is 1 and any other order flips a coefficient every few thousand.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def _dct8_np() -> np.ndarray:
    n = 8
    c = np.zeros((n, n), dtype=np.float64)
    for k in range(n):
        for i in range(n):
            c[k, i] = math.cos(math.pi * (2 * i + 1) * k / (2 * n))
    c *= math.sqrt(2.0 / n)
    c[0, :] *= 1.0 / math.sqrt(2.0)
    return c.astype(np.float32)


def dct8_matrix(device=None) -> torch.Tensor:
    """The orthonormal 8-point DCT-II matrix C (C @ C.T == I), f32."""
    return torch.from_numpy(_dct8_np()).to(device)


def pin_fp32_matmul() -> None:
    """Keep f32 matrix products in full f32 on the card.

    Hopper may run f32 matmuls and convolutions in TF32 (10-bit mantissa),
    which moves DCT coefficients across quantizer rounding boundaries — the
    GPU twin of the bf16 hazard the JAX package pins ``Precision.HIGHEST``
    against. Every matmul on a bit-exact path calls this first.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def blockify(plane: torch.Tensor) -> torch.Tensor:
    """[..., H, W] → [..., H/8, W/8, 8, 8] blocks (a view when possible)."""
    *lead, h, w = plane.shape
    x = plane.reshape(*lead, h // 8, 8, w // 8, 8)
    return x.transpose(-3, -2)


def _dot8(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """f32 ``a @ b`` for a [..., 8] and b [8, 8], summed in XLA:CPU's order:
    acc_k = fma(a_{k+4}, b_{k+4}, a_k*b_k) for k < 4, then
    (acc0 + acc1) + (acc2 + acc3)."""
    a64 = a.to(torch.float64)[..., :, None]
    b64 = b.to(torch.float64)
    terms = a64 * b64                                  # [..., 8, 8] exact
    acc = terms[..., :4, :].to(torch.float32)
    acc = (terms[..., 4:, :] + acc.to(torch.float64)).to(torch.float32)
    return (acc[..., 0, :] + acc[..., 1, :]) + (acc[..., 2, :] + acc[..., 3, :])


def block_dct2(blocks: torch.Tensor) -> torch.Tensor:
    """2-D DCT-II of [..., 8, 8] f32 blocks (orthonormal): C · X · Cᵀ,
    vertical pass first, each 8-term sum in the JAX step's order."""
    c = dct8_matrix(blocks.device)
    ct = c.T.contiguous()
    v = _dot8(blocks.transpose(-1, -2), ct)          # [..., k, i] = (C X)ᵀ
    return _dot8(v.transpose(-1, -2), ct)            # [..., i, l]


def block_dct2_einsum(blocks: torch.Tensor) -> torch.Tensor:
    """The same transform as one library call (``torch.einsum``), in full
    f32. The port's path never calls it: it is the library yardstick that
    chip_smoke.py times beside the kernel."""
    pin_fp32_matmul()
    c = dct8_matrix(blocks.device)
    return torch.einsum("ij,...jk,lk->...il", c, blocks, c)

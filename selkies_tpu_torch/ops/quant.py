"""Quantization tables, quality scaling, and zigzag ordering (numpy).

Base tables and the quality→scale mapping follow the public JPEG spec
(ITU-T T.81 Annex K) and the IJG convention, which is what the reference's
pixelflux JPEG path (libjpeg-turbo) and every browser decoder expect.
The port's copy of the numpy half of ``selkies_tpu/ops/quant.py``.
Quantization itself runs on the device as a multiply by the f32
reciprocal table, inside the DCT kernel's epilogue (ops/dct_quant.py).
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np

# ITU-T T.81 Annex K.1 / K.2 base tables (raster order).
_BASE_LUMA = np.array(
    [
        16, 11, 10, 16, 24, 40, 51, 61,
        12, 12, 14, 19, 26, 58, 60, 55,
        14, 13, 16, 24, 40, 57, 69, 56,
        14, 17, 22, 29, 51, 87, 80, 62,
        18, 22, 37, 56, 68, 109, 103, 77,
        24, 35, 55, 64, 81, 104, 113, 92,
        49, 64, 78, 87, 103, 121, 120, 101,
        72, 92, 95, 98, 112, 100, 103, 99,
    ],
    dtype=np.int32,
).reshape(8, 8)

_BASE_CHROMA = np.array(
    [
        17, 18, 24, 47, 99, 99, 99, 99,
        18, 21, 26, 66, 99, 99, 99, 99,
        24, 26, 56, 99, 99, 99, 99, 99,
        47, 66, 99, 99, 99, 99, 99, 99,
        99, 99, 99, 99, 99, 99, 99, 99,
        99, 99, 99, 99, 99, 99, 99, 99,
        99, 99, 99, 99, 99, 99, 99, 99,
        99, 99, 99, 99, 99, 99, 99, 99,
    ],
    dtype=np.int32,
).reshape(8, 8)

# Zigzag scan: ZIGZAG[k] = raster index of the k-th zigzag coefficient.
ZIGZAG = np.array(
    [
        0, 1, 8, 16, 9, 2, 3, 10,
        17, 24, 32, 25, 18, 11, 4, 5,
        12, 19, 26, 33, 40, 48, 41, 34,
        27, 20, 13, 6, 7, 14, 21, 28,
        35, 42, 49, 56, 57, 50, 43, 36,
        29, 22, 15, 23, 30, 37, 44, 51,
        58, 59, 52, 45, 38, 31, 39, 46,
        53, 60, 61, 54, 47, 55, 62, 63,
    ],
    dtype=np.int32,
)


def base_quant_tables() -> Tuple[np.ndarray, np.ndarray]:
    return _BASE_LUMA.copy(), _BASE_CHROMA.copy()


@functools.lru_cache(maxsize=128)
def quality_scaled_tables(quality: int) -> Tuple[np.ndarray, np.ndarray]:
    """IJG quality scaling: Q in [1, 100] → (luma, chroma) uint8 tables."""
    q = max(1, min(100, int(quality)))
    scale = 5000 // q if q < 50 else 200 - 2 * q

    def scaled(base: np.ndarray) -> np.ndarray:
        t = (base * scale + 50) // 100
        return np.clip(t, 1, 255).astype(np.uint8)

    return scaled(_BASE_LUMA), scaled(_BASE_CHROMA)

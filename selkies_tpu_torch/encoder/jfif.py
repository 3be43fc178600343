"""JFIF (baseline JPEG) container writer (copy of ``selkies_tpu/encoder/jfif.py``).

Each stripe is an independent, self-contained JFIF image — the stripe is the
unit of parallelism and of client-side decode (the reference client feeds each
0x03 payload straight to an ``ImageDecoder``, selkies-core.js:2908-2924).
"""

from __future__ import annotations

import struct

import numpy as np

from .jpeg_tables import std_tables
from ..ops.quant import ZIGZAG


def _marker(tag: int, payload: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, tag, len(payload) + 2) + payload


def jfif_headers(
    width: int,
    height: int,
    qtable_luma: np.ndarray,
    qtable_chroma: np.ndarray,
    subsampling: str = "420",
) -> bytes:
    """SOI..SOS headers for a 3-component YCbCr baseline image.

    ``qtable_*`` are 8x8 arrays in raster order (written zigzagged, as DQT
    requires). ``subsampling``: "420" (2x2,1x1,1x1) or "444".
    """
    zz = ZIGZAG
    dc_l, ac_l, dc_c, ac_c = std_tables()

    out = bytearray(b"\xff\xd8")  # SOI
    out += _marker(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")  # APP0

    ql = qtable_luma.reshape(64).astype(np.uint8)[zz]
    qc = qtable_chroma.reshape(64).astype(np.uint8)[zz]
    out += _marker(0xDB, bytes([0x00]) + ql.tobytes())  # DQT id 0
    out += _marker(0xDB, bytes([0x01]) + qc.tobytes())  # DQT id 1

    if subsampling == "420":
        y_sampling = 0x22
    elif subsampling == "444":
        y_sampling = 0x11
    else:
        raise ValueError(f"unsupported subsampling {subsampling!r}")
    sof = struct.pack(">BHHB", 8, height, width, 3)
    sof += bytes([1, y_sampling, 0])  # Y: id 1, sampling, qtable 0
    sof += bytes([2, 0x11, 1])        # Cb
    sof += bytes([3, 0x11, 1])        # Cr
    out += _marker(0xC0, sof)  # SOF0 baseline

    out += _marker(0xC4, dc_l.dht_payload(0, 0))
    out += _marker(0xC4, ac_l.dht_payload(1, 0))
    out += _marker(0xC4, dc_c.dht_payload(0, 1))
    out += _marker(0xC4, ac_c.dht_payload(1, 1))

    sos = bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0])
    out += _marker(0xDA, sos)
    return bytes(out)


EOI = b"\xff\xd9"

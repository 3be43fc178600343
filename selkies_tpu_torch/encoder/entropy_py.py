"""Pure-Python baseline-JPEG entropy coder — reference implementation.

The port's copy of ``selkies_tpu/encoder/entropy_py.py``. It is the host
coder for stripes whose device pack overflowed, and the oracle the device
packer is held against. Input is the device step's output: zigzagged,
quantized int16 coefficients per 8x8 block.
"""

from __future__ import annotations

import numpy as np

from .jpeg_tables import std_tables


class BitWriter:
    """MSB-first bit packer with JPEG 0xFF byte stuffing."""

    def __init__(self) -> None:
        self._out = bytearray()
        self._acc = 0
        self._nbits = 0

    def write(self, value: int, nbits: int) -> None:
        if nbits == 0:
            return
        self._acc = (self._acc << nbits) | (value & ((1 << nbits) - 1))
        self._nbits += nbits
        while self._nbits >= 8:
            self._nbits -= 8
            byte = (self._acc >> self._nbits) & 0xFF
            self._out.append(byte)
            if byte == 0xFF:
                self._out.append(0x00)
        self._acc &= (1 << self._nbits) - 1

    def flush(self) -> bytes:
        """Pad with 1-bits to a byte boundary (T.81 F.1.2.3) and return."""
        if self._nbits:
            pad = 8 - self._nbits
            self.write((1 << pad) - 1, pad)
        return bytes(self._out)


def _category(v: int) -> int:
    return int(v).bit_length() if v > 0 else int(-v).bit_length()


def _encode_block(bw: BitWriter, zz: np.ndarray, pred_dc: int, dc_tab, ac_tab) -> int:
    """Encode one zigzagged 64-coefficient block; returns its DC value."""
    dc = int(zz[0])
    diff = dc - pred_dc
    size = _category(diff)
    code, length = dc_tab.codes[size]
    bw.write(code, length)
    if size:
        # negative values are stored as ones'-complement (T.81 F.1.2.1)
        bw.write(diff if diff > 0 else diff + (1 << size) - 1, size)

    run = 0
    for k in range(1, 64):
        v = int(zz[k])
        if v == 0:
            run += 1
            continue
        while run >= 16:
            code, length = ac_tab.codes[0xF0]  # ZRL
            bw.write(code, length)
            run -= 16
        size = _category(v)
        code, length = ac_tab.codes[(run << 4) | size]
        bw.write(code, length)
        bw.write(v if v > 0 else v + (1 << size) - 1, size)
        run = 0
    if run:
        code, length = ac_tab.codes[0x00]  # EOB
        bw.write(code, length)
    return dc


def encode_scan_420(
    y_blocks: np.ndarray,   # [by, bx, 64] int (by, bx even)
    cb_blocks: np.ndarray,  # [by/2, bx/2, 64]
    cr_blocks: np.ndarray,  # [by/2, bx/2, 64]
) -> bytes:
    """Entropy-code a 4:2:0 interleaved scan (MCU = 4 Y + Cb + Cr)."""
    dc_l, ac_l, dc_c, ac_c = std_tables()
    by, bx, _ = y_blocks.shape
    bw = BitWriter()
    pred_y = pred_cb = pred_cr = 0
    for mr in range(by // 2):
        for mc in range(bx // 2):
            for dy in (0, 1):
                for dx in (0, 1):
                    pred_y = _encode_block(
                        bw, y_blocks[2 * mr + dy, 2 * mc + dx], pred_y, dc_l, ac_l)
            pred_cb = _encode_block(bw, cb_blocks[mr, mc], pred_cb, dc_c, ac_c)
            pred_cr = _encode_block(bw, cr_blocks[mr, mc], pred_cr, dc_c, ac_c)
    return bw.flush()


def encode_scan_444(
    y_blocks: np.ndarray, cb_blocks: np.ndarray, cr_blocks: np.ndarray
) -> bytes:
    """Entropy-code a 4:4:4 interleaved scan (MCU = Y + Cb + Cr)."""
    dc_l, ac_l, dc_c, ac_c = std_tables()
    by, bx, _ = y_blocks.shape
    bw = BitWriter()
    pred_y = pred_cb = pred_cr = 0
    for r in range(by):
        for c in range(bx):
            pred_y = _encode_block(bw, y_blocks[r, c], pred_y, dc_l, ac_l)
            pred_cb = _encode_block(bw, cb_blocks[r, c], pred_cb, dc_c, ac_c)
            pred_cr = _encode_block(bw, cr_blocks[r, c], pred_cr, dc_c, ac_c)
    return bw.flush()

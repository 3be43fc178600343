"""H.264 4x4 integer transform, Hadamard DC transforms and quantization.

Counterpart of ``selkies_tpu/ops/h264_transform.py``: the same tables and
the same integer arithmetic (ITU-T H.264 §8.5), on ``int32`` tensors, so
the levels and the reconstruction are bit-identical to the JAX package and
to a conforming decoder.

Layout: a plane (H, W) is viewed as 4x4 blocks (H//4, W//4, 4, 4).

``qp`` is a Python int, or an ``[S]`` tensor with one QP per stripe along
the first axis of the blocks (the JAX package vmaps a scalar QP over the
stripes; here the stripe axis is written out).
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

QP = Union[int, torch.Tensor]

# -- core tables (the JAX package's, verbatim) --------------------------------

_CF = np.array([[1, 1, 1, 1],
                [2, 1, -1, -2],
                [1, -1, -1, 1],
                [1, -2, 2, -1]], np.int32)

# quant multiplier MF per QP%6 x coefficient class
_MF = np.array([
    [13107, 5243, 8066],
    [11916, 4660, 7490],
    [10082, 4194, 6554],
    [9362, 3647, 5825],
    [8192, 3355, 5243],
    [7282, 2893, 4559],
], np.int32)

# dequant scale V (decoder LevelScale4x4) per QP%6 x class
_V = np.array([
    [10, 16, 13],
    [11, 18, 14],
    [13, 20, 16],
    [14, 23, 18],
    [16, 25, 20],
    [18, 29, 23],
], np.int32)

# position -> class map of a 4x4 block
_POS_CLASS = np.array([[0, 2, 0, 2],
                       [2, 1, 2, 1],
                       [0, 2, 0, 2],
                       [2, 1, 2, 1]], np.int32)

MF_TABLE = _MF[:, _POS_CLASS]          # (6, 4, 4)
V_TABLE = _V[:, _POS_CLASS]            # (6, 4, 4)
_MF00 = np.ascontiguousarray(MF_TABLE[:, 0, 0])
_V00 = np.ascontiguousarray(V_TABLE[:, 0, 0])

# QPc from QPy (chroma_qp_index_offset = 0), §8.5.8
_QPC = np.concatenate([
    np.arange(30),
    np.array([29, 30, 31, 32, 32, 33, 34, 34, 35, 35, 36, 36, 37, 37, 37,
              38, 38, 38, 39, 39, 39, 39]),
]).astype(np.int32)

ZIGZAG_4x4 = np.array([0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15],
                      np.int32)

_consts = {}


def const(arr: np.ndarray, device) -> torch.Tensor:
    """``arr`` as a tensor on ``device``, uploaded once per device: a
    per-frame upload from pageable memory would wait for the stream."""
    key = (id(arr), torch.device(device))
    t = _consts.get(key)
    if t is None:
        t = torch.from_numpy(np.ascontiguousarray(arr)).to(device)
        _consts[key] = t
    return t


def qpc_for(qp: QP) -> QP:
    """Chroma QP for a luma QP (chroma_qp_index_offset == 0)."""
    if isinstance(qp, (int, np.integer)):
        return int(_QPC[min(max(int(qp), 0), 51)])
    return const(_QPC, qp.device)[qp.clamp(0, 51).long()]


def _lead(v: torch.Tensor, x: torch.Tensor, trailing: int = 0) -> torch.Tensor:
    """Shape a per-stripe value ``v`` ([S] + ``trailing`` dims) to broadcast
    against ``x`` along its first axis."""
    tail = tuple(v.shape[1:])
    return v.reshape((v.shape[0],) + (1,) * (x.dim() - 1 - trailing) + tail)


def _params(table: np.ndarray, qp: QP, x: torch.Tensor):
    """(table[qp % 6], qp // 6) shaped to broadcast against x: a (6, 4, 4)
    table against the 4x4 blocks, a (6,) table against whole blocks. An int
    QP stays a Python int (no per-call upload)."""
    t = const(table, x.device)
    if not isinstance(qp, torch.Tensor):
        return t[int(qp) % 6], int(qp) // 6
    q = qp.to(torch.int32)
    return (_lead(t[(q % 6).long()], x, trailing=table.ndim - 1),
            _lead(q // 6, x))


def _relu(v):
    return max(v, 0) if isinstance(v, int) else torch.clamp(v, min=0)


# ---------------------------------------------------------------------------
# block layout


def plane_to_blocks(plane: torch.Tensor) -> torch.Tensor:
    """(..., H, W) -> (..., H//4, W//4, 4, 4)."""
    h, w = plane.shape[-2:]
    lead = plane.shape[:-2]
    return plane.reshape(*lead, h // 4, 4, w // 4, 4).transpose(-3, -2)


def blocks_to_plane(blocks: torch.Tensor) -> torch.Tensor:
    """(..., H//4, W//4, 4, 4) -> (..., H, W)."""
    nby, nbx = blocks.shape[-4:-2]
    lead = blocks.shape[:-4]
    return blocks.transpose(-3, -2).reshape(*lead, nby * 4, nbx * 4)


# ---------------------------------------------------------------------------
# forward/inverse core transform


def _cf_1d(x0, x1, x2, x3):
    s0 = x0 + x3
    s1 = x1 + x2
    d0 = x0 - x3
    d1 = x1 - x2
    return s0 + s1, 2 * d0 + d1, s0 - s1, d0 - 2 * d1


def forward_dct4(blocks: torch.Tensor) -> torch.Tensor:
    """Core transform W = Cf . X . Cf^T over (..., 4, 4) int32 blocks."""
    x = blocks.to(torch.int32)
    v = torch.stack(_cf_1d(x[..., 0, :], x[..., 1, :],
                           x[..., 2, :], x[..., 3, :]), dim=-2)
    return torch.stack(_cf_1d(v[..., :, 0], v[..., :, 1],
                              v[..., :, 2], v[..., :, 3]), dim=-1)


def inverse_dct4(coeffs: torch.Tensor) -> torch.Tensor:
    """Decoder inverse transform (§8.5.12.2) with the final (x+32)>>6:
    horizontal butterflies, then vertical (the >>1 floors fix the order)."""
    d = coeffs.to(torch.int32)
    d0, d1, d2, d3 = d[..., :, 0], d[..., :, 1], d[..., :, 2], d[..., :, 3]
    e0 = d0 + d2
    e1 = d0 - d2
    e2 = (d1 >> 1) - d3
    e3 = d1 + (d3 >> 1)
    f = torch.stack([e0 + e3, e1 + e2, e1 - e2, e0 - e3], dim=-1)
    f0, f1, f2, f3 = f[..., 0, :], f[..., 1, :], f[..., 2, :], f[..., 3, :]
    g0 = f0 + f2
    g1 = f0 - f2
    g2 = (f1 >> 1) - f3
    g3 = f1 + (f3 >> 1)
    r = torch.stack([g0 + g3, g1 + g2, g1 - g2, g0 - g3], dim=-2)
    return (r + 32) >> 6


# ---------------------------------------------------------------------------
# AC / plain 4x4 quantization


def quant4(coeffs: torch.Tensor, qp: QP, intra: bool) -> torch.Tensor:
    """Quantize core-transform output (|W|.MF <= 1.2e8 fits int32); levels
    are clamped so a decoder's int16 dequantized value cannot overflow."""
    mf, qd6 = _params(MF_TABLE, qp, coeffs)
    v, _ = _params(V_TABLE, qp, coeffs)
    qbits = 15 + qd6
    f = (1 << qbits) // (3 if intra else 6)
    w = coeffs.to(torch.int32)
    mag = (w.abs() * mf + f) >> qbits
    mag = torch.minimum(mag, (32767 >> qd6) // v)
    return (torch.sign(w) * mag).to(torch.int32)


def dequant4(levels: torch.Tensor, qp: QP) -> torch.Tensor:
    """Decoder §8.5.12.1 scaling for plain 4x4 blocks."""
    v, qd6 = _params(V_TABLE, qp, levels)
    return ((levels.to(torch.int32) * v) << qd6).to(torch.int32)


# ---------------------------------------------------------------------------
# Intra16x16 luma DC path


def _h4_1d(x0, x1, x2, x3):
    a = x0 + x1
    b = x2 + x3
    c = x0 - x1
    e = x2 - x3
    return a + b, a - b, c - e, c + e


def _h4_2d(x: torch.Tensor) -> torch.Tensor:
    v = torch.stack(_h4_1d(x[..., 0, :], x[..., 1, :],
                           x[..., 2, :], x[..., 3, :]), dim=-2)
    return torch.stack(_h4_1d(v[..., :, 0], v[..., :, 1],
                              v[..., :, 2], v[..., :, 3]), dim=-1)


def hadamard4_fwd(dc: torch.Tensor) -> torch.Tensor:
    """Encoder DC transform (H.X.H^T)/2 over (..., 4, 4)."""
    return _h4_2d(dc.to(torch.int32)) >> 1


def quant_dc16(dc_t: torch.Tensor, qp: QP) -> torch.Tensor:
    """Quantize Hadamard-transformed luma DC: z = y.MF00 >> (16 + qp/6),
    round to nearest, clamped to int16."""
    mf00, qd6 = _params(_MF00, qp, dc_t)
    s = 16 + qd6
    f = (1 << s) >> 1
    w = dc_t.to(torch.int32)
    mag = torch.clamp((w.abs() * mf00 + f) >> s, max=32767)
    return (torch.sign(w) * mag).to(torch.int32)


def dequant_dc16(levels: torch.Tensor, qp: QP) -> torch.Tensor:
    """Decoder §8.5.10: inverse Hadamard first, then LevelScale = 16.V."""
    f = _h4_2d(levels.to(torch.int32))
    v00, shift = _params(_V00, qp, levels)
    ls = v00 * 16
    hi = (f * ls) << _relu(shift - 6)
    lo_shift = _relu(6 - shift)
    lo = (f * ls + (1 << _relu(lo_shift - 1))) >> lo_shift
    if isinstance(shift, int):               # qp >= 36 <=> qp // 6 >= 6
        return (hi if shift >= 6 else lo).to(torch.int32)
    return torch.where(shift >= 6, hi, lo).to(torch.int32)


# ---------------------------------------------------------------------------
# chroma DC path (2x2)


def _h2_2d(x: torch.Tensor) -> torch.Tensor:
    a = x[..., 0, 0]
    b = x[..., 0, 1]
    c = x[..., 1, 0]
    d = x[..., 1, 1]
    return torch.stack([
        torch.stack([a + b + c + d, a - b + c - d], dim=-1),
        torch.stack([a + b - c - d, a - b - c + d], dim=-1),
    ], dim=-2)


def hadamard2_fwd(dc: torch.Tensor) -> torch.Tensor:
    """Encoder chroma DC transform over (..., 2, 2) (no scaling)."""
    return _h2_2d(dc.to(torch.int32))


def quant_dc2(dc_t: torch.Tensor, qpc: QP) -> torch.Tensor:
    """Chroma DC quant: the same >> (16 + qp/6) shift as quant_dc16, with
    the int16 decoder bound |z.V00.2^(qp/6)| <= 32767."""
    mf00, qd6 = _params(_MF00, qpc, dc_t)
    v00, _ = _params(_V00, qpc, dc_t)
    s = 16 + qd6
    f = (1 << s) >> 1
    w = dc_t.to(torch.int32)
    mag = (w.abs() * mf00 + f) >> s
    mag = torch.minimum(mag, (32767 >> qd6) // v00)
    return (torch.sign(w) * mag).to(torch.int32)


def dequant_dc2(levels: torch.Tensor, qpc: QP) -> torch.Tensor:
    """Decoder §8.5.11: inverse 2x2 Hadamard, then ((f.16.V)<<(qp/6))>>5."""
    f = _h2_2d(levels.to(torch.int32))
    v00, qd6 = _params(_V00, qpc, levels)
    return (((f * (v00 * 16)) << qd6) >> 5).to(torch.int32)


# ---------------------------------------------------------------------------
# numpy mirror (a test oracle: an independent, readable decoder-side model)

# the Hadamard matrices of the mirror's DC dequantizers
_H4 = np.array([[1, 1, 1, 1],
                [1, 1, -1, -1],
                [1, -1, -1, 1],
                [1, -1, 1, -1]], np.int32)

_H2 = np.array([[1, 1], [1, -1]], np.int32)


class NumpyMirror:
    """Pure-numpy decoder-side reference for the ops above (the JAX
    package's ``NumpyMirror``, verbatim)."""

    @staticmethod
    def inverse_dct4(d):
        # §8.5.12.2 verbatim: horizontal (along j) then vertical (along i)
        d = d.astype(np.int64)
        e = np.empty_like(d)
        e[..., :, 0] = d[..., :, 0] + d[..., :, 2]
        e[..., :, 1] = d[..., :, 0] - d[..., :, 2]
        e[..., :, 2] = (d[..., :, 1] >> 1) - d[..., :, 3]
        e[..., :, 3] = d[..., :, 1] + (d[..., :, 3] >> 1)
        f = np.empty_like(d)
        f[..., :, 0] = e[..., :, 0] + e[..., :, 3]
        f[..., :, 1] = e[..., :, 1] + e[..., :, 2]
        f[..., :, 2] = e[..., :, 1] - e[..., :, 2]
        f[..., :, 3] = e[..., :, 0] - e[..., :, 3]
        g = np.empty_like(f)
        g[..., 0, :] = f[..., 0, :] + f[..., 2, :]
        g[..., 1, :] = f[..., 0, :] - f[..., 2, :]
        g[..., 2, :] = (f[..., 1, :] >> 1) - f[..., 3, :]
        g[..., 3, :] = f[..., 1, :] + (f[..., 3, :] >> 1)
        r = np.empty_like(g)
        r[..., 0, :] = g[..., 0, :] + g[..., 3, :]
        r[..., 1, :] = g[..., 1, :] + g[..., 2, :]
        r[..., 2, :] = g[..., 1, :] - g[..., 2, :]
        r[..., 3, :] = g[..., 0, :] - g[..., 3, :]
        return (r + 32) >> 6

    @staticmethod
    def dequant4(levels, qp):
        return (levels.astype(np.int64) * V_TABLE[qp % 6]) << (qp // 6)

    @staticmethod
    def dequant_dc16(levels, qp):
        f = np.einsum("ij,...jk,lk->...il", _H4, levels.astype(np.int64), _H4)
        ls = V_TABLE[qp % 6, 0, 0] * 16
        if qp >= 36:
            return (f * ls) << (qp // 6 - 6)
        s = 6 - qp // 6
        return (f * ls + (1 << (s - 1))) >> s

    @staticmethod
    def dequant_dc2(levels, qpc):
        f = np.einsum("ij,...jk,lk->...il", _H2, levels.astype(np.int64), _H2)
        ls = V_TABLE[qpc % 6, 0, 0] * 16
        return ((f * ls) << (qpc // 6)) >> 5

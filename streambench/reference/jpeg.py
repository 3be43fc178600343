"""Plain reference of the JPEG-stripe profile, from pixels to wire bytes.

What a delivered 0x03 message must hold, worked out again from the frame
the benchmark's source handed the server: full-range BT.601 colour
conversion, 4:2:0 by 2x2 means, the orthonormal 8x8 DCT-II, quantization
by the IJG-scaled tables (a multiply by the float32 reciprocal, rounded
half to even), zigzag order, baseline Huffman coding with the standard
tables and 0xFF stuffing, one JFIF image per stripe, and the wire header
``[0x03][0x00][frame id u16][y_start u16]``.

Every float32 step is written in the one order of operations that the
profile fixes (each DCT sum as four fused multiply-add chains added as a
tree, each fused step exact in float64 and rounded once), so the bytes are
exact: a comparison with the program's delivered bytes has the limit 0.
``precision="bfloat16"`` is the control: the same steps in bfloat16.

Which stripes a frame must carry: every stripe whose pixels changed since
the frame the session encoded before it (all of them for a session's
first frame), each at the profile's quality; a stripe may also come at the
paint-over quality, and an unchanged stripe only so. The header's
quantization tables say which of the two a stripe was coded at.
"""

from __future__ import annotations

import math
import struct
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from . import Session
from .jpeg_tables import ZIGZAG, quality_scaled_tables, std_tables

# Rows: Y, Cb, Cr; columns: R, G, B (JFIF, full range).
_RGB2YCC = np.array(
    [
        [0.299, 0.587, 0.114],
        [-0.168736, -0.331264, 0.5],
        [0.5, -0.418688, -0.081312],
    ],
    dtype=np.float32,
)

EOI = b"\xff\xd9"
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


# -- transform -------------------------------------------------------------


def dct8_np() -> np.ndarray:
    """The orthonormal 8-point DCT-II matrix, float32."""
    n = 8
    c = np.zeros((n, n), dtype=np.float64)
    for k in range(n):
        for i in range(n):
            c[k, i] = math.cos(math.pi * (2 * i + 1) * k / (2 * n))
    c *= math.sqrt(2.0 / n)
    c[0, :] *= 1.0 / math.sqrt(2.0)
    return c.astype(np.float32)


def ycbcr(rgb: torch.Tensor, dtype: torch.dtype):
    """[H, W, 3] uint8 -> Y, Cb, Cr planes in ``dtype``: y = m0*r + m1*g +
    m2*b, each product and sum rounded to ``dtype``."""
    x = rgb.to(dtype)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    m = torch.from_numpy(_RGB2YCC).to(device=rgb.device, dtype=dtype)
    y = m[0, 0] * r + m[0, 1] * g + m[0, 2] * b
    cb = m[1, 0] * r + m[1, 1] * g + m[1, 2] * b + 128.0
    cr = m[2, 0] * r + m[2, 1] * g + m[2, 2] * b + 128.0
    return y, cb, cr


def subsample(plane: torch.Tensor) -> torch.Tensor:
    """2x2 means: (row-0 pair + row-1 pair) / 4."""
    h, w = plane.shape
    p = plane.reshape(h // 2, 2, w // 2, 2)
    top = p[:, 0, :, 0] + p[:, 0, :, 1]
    bottom = p[:, 1, :, 0] + p[:, 1, :, 1]
    return (top + bottom) / 4.0


def _dot8(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """float32 ``a @ b`` over 8 terms: acc_k = fma(a_{k+4}, b_{k+4},
    a_k*b_k) for k < 4 (each exact in float64, rounded once), then
    (acc0 + acc1) + (acc2 + acc3)."""
    terms = a.to(torch.float64)[..., :, None] * b.to(torch.float64)
    acc = terms[..., :4, :].to(torch.float32)
    acc = (terms[..., 4:, :] + acc.to(torch.float64)).to(torch.float32)
    return (acc[..., 0, :] + acc[..., 1, :]) + (acc[..., 2, :] + acc[..., 3, :])


def blocks_of(plane: torch.Tensor) -> torch.Tensor:
    h, w = plane.shape
    return plane.reshape(h // 8, 8, w // 8, 8).transpose(1, 2)


def quantized(plane: torch.Tensor, recip_rows: torch.Tensor,
              dtype: torch.dtype) -> np.ndarray:
    """[H, W] plane -> [H/8, W/8, 64] int16 zigzag coefficients.
    ``recip_rows`` [H/8, 8, 8]: each block row's float32 reciprocal
    table."""
    h, w = plane.shape
    c = torch.from_numpy(dct8_np()).to(plane.device)
    x = blocks_of(plane) - 128.0
    if dtype == torch.float32:
        ct = c.T.contiguous()
        v = _dot8(x.transpose(-1, -2), ct)          # (C X)^T
        coeffs = _dot8(v.transpose(-1, -2), ct)     # C X C^T
    else:
        cd = c.to(dtype)
        coeffs = cd @ x @ cd.T
    q = torch.round(coeffs * recip_rows.to(coeffs.dtype)[:, None])
    q = q.to(torch.int16).reshape(h // 8, w // 8, 64)
    zz = torch.from_numpy(ZIGZAG.astype(np.int64)).to(plane.device)
    return q.index_select(-1, zz).cpu().numpy()


# -- entropy coding ----------------------------------------------------------


def _size(v: np.ndarray) -> np.ndarray:
    """The magnitude category of each value: the bit length of |v|."""
    return np.frexp(np.abs(v).astype(np.float64))[1].astype(np.int64)


def _extra(v: np.ndarray, size: np.ndarray) -> np.ndarray:
    """The bits that follow a category's code: v, or v + 2^size - 1 for a
    negative v (T.81 F.1.2.1)."""
    return np.where(v > 0, v, v + (1 << size) - 1)


def pack_bits(values: np.ndarray, lengths: np.ndarray) -> bytes:
    """Each value's ``lengths`` low bits, MSB first, one after another;
    padded with 1-bits to a byte (T.81 F.1.2.3) and 0xFF-stuffed."""
    total = int(lengths.sum())
    pad = -total % 8
    values = np.append(values, (1 << pad) - 1)
    lengths = np.append(lengths, pad)
    which = np.repeat(np.arange(len(lengths)), lengths)
    starts = np.cumsum(lengths) - lengths
    shift = lengths[which] - 1 - (np.arange(total + pad) - starts[which])
    out = np.packbits(((values[which] >> shift) & 1).astype(np.uint8))
    return np.insert(out, np.flatnonzero(out == 0xFF) + 1, 0).tobytes()


def encode_scan_420(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> bytes:
    """A 4:2:0 interleaved scan (MCU = 4 Y blocks, Cb, Cr) of zigzag
    coefficients with the standard tables; DC prediction starts at 0.
    Each block is its DC difference, then each nonzero AC coefficient
    after its run of zeros (a ZRL for each 16 of them), then an EOB unless
    coefficient 63 is nonzero."""
    dc_l, ac_l, dc_c, ac_c = std_tables()
    by, bx, _ = y.shape
    nm = (by // 2) * (bx // 2)
    blocks = np.concatenate([
        y.reshape(by // 2, 2, bx // 2, 2, 64).transpose(0, 2, 1, 3, 4)
        .reshape(nm, 4, 64), cb.reshape(nm, 1, 64), cr.reshape(nm, 1, 64)],
        axis=1).reshape(nm * 6, 64).astype(np.int64)
    comp = np.tile(np.array([0, 0, 0, 0, 1, 2]), nm)
    luma = comp == 0
    # DC: the difference from the component's previous block
    dc = blocks[:, 0]
    diff = np.empty_like(dc)
    for c in range(3):
        m = comp == c
        diff[m] = np.diff(dc[m], prepend=0)
    dsize = _size(diff)
    dcode = np.where(luma, dc_l.code_arr[dsize], dc_c.code_arr[dsize])
    dlen = np.where(luma, dc_l.len_arr[dsize], dc_c.len_arr[dsize])
    # AC: nonzero coefficients in block order, each after its zero run
    b, j = np.nonzero(blocks[:, 1:])
    i = j + 1
    first = np.ones(len(b), bool)
    first[1:] = b[1:] != b[:-1]
    prev = np.where(first, 0, np.roll(i, 1))
    run = i - prev - 1
    zrl, rest = run // 16, run % 16
    v = blocks[b, i]
    size = _size(v)
    sym = (rest << 4) | size
    al = luma[b]
    acode = np.where(al, ac_l.code_arr[sym], ac_c.code_arr[sym])
    alen = np.where(al, ac_l.len_arr[sym], ac_c.len_arr[sym])
    # ZRLs before a coefficient, an EOB after a block's last coefficient
    zb = np.repeat(np.arange(len(b)), zrl)
    zkey = np.repeat(b * 260 + i * 4, zrl) + (
        np.arange(len(zb)) - np.repeat(np.cumsum(zrl) - zrl, zrl))
    last = np.zeros(len(blocks), np.int64)
    np.maximum.at(last, b, i)
    eob = np.flatnonzero(last < 63)
    el, zl = luma[eob], luma[b[zb]]
    zcode = np.where(zl, ac_l.code_arr[0xF0], ac_c.code_arr[0xF0])
    zlen = np.where(zl, ac_l.len_arr[0xF0], ac_c.len_arr[0xF0])
    ecode = np.where(el, ac_l.code_arr[0x00], ac_c.code_arr[0x00])
    elen = np.where(el, ac_l.len_arr[0x00], ac_c.len_arr[0x00])
    n = len(blocks)
    keys = np.concatenate([np.arange(n) * 260, b * 260 + i * 4 + 3, zkey,
                           eob * 260 + 256])
    codes = np.concatenate([
        (dcode.astype(np.int64) << dsize) | _extra(diff, dsize),
        (acode.astype(np.int64) << size) | _extra(v, size),
        zcode.astype(np.int64), ecode.astype(np.int64)])
    lens = np.concatenate([dlen + dsize, alen + size, zlen,
                           elen]).astype(np.int64)
    order = np.argsort(keys, kind="stable")
    return pack_bits(codes[order], lens[order])


def _marker(tag: int, payload: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, tag, len(payload) + 2) + payload


def jfif_headers(width: int, height: int, qy: np.ndarray,
                 qc: np.ndarray) -> bytes:
    """SOI .. SOS of a baseline 4:2:0 YCbCr JFIF image."""
    dc_l, ac_l, dc_c, ac_c = std_tables()
    out = bytearray(b"\xff\xd8")
    out += _marker(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    out += _marker(0xDB, bytes([0x00]) + qy.reshape(64).astype(np.uint8)
                   [ZIGZAG].tobytes())
    out += _marker(0xDB, bytes([0x01]) + qc.reshape(64).astype(np.uint8)
                   [ZIGZAG].tobytes())
    sof = struct.pack(">BHHB", 8, height, width, 3)
    sof += bytes([1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1])
    out += _marker(0xC0, sof)
    out += _marker(0xC4, dc_l.dht_payload(0, 0))
    out += _marker(0xC4, ac_l.dht_payload(1, 0))
    out += _marker(0xC4, dc_c.dht_payload(0, 1))
    out += _marker(0xC4, ac_c.dht_payload(1, 1))
    out += _marker(0xDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0]))
    return bytes(out)


def wire_stripe(frame_id: int, y_start: int, jpeg: bytes) -> bytes:
    return bytes((0x03, 0)) + struct.pack(">HH", frame_id & 0xFFFF,
                                          y_start & 0xFFFF) + jpeg


# -- the profile -------------------------------------------------------------


def padded(frame: np.ndarray, pad_h: int, pad_w: int) -> np.ndarray:
    """The frame with its last row and column repeated out to the padded
    geometry."""
    h, w = frame.shape[:2]
    return np.pad(frame, ((0, pad_h - h), (0, pad_w - w), (0, 0)),
                  mode="edge")


class JpegReference:
    """The JPEG-stripe profile of one configuration."""

    def __init__(self, config: dict, device="cpu",
                 precision: str = "float32") -> None:
        ref = config["reference_settings"]
        self.width, self.height = int(config["width"]), int(config["height"])
        self.stripe_h = int(ref["stripe_height"])
        self.pad_w = -(-self.width // 16) * 16
        self.pad_h = -(-self.height // self.stripe_h) * self.stripe_h
        self.n_stripes = self.pad_h // self.stripe_h
        self.device = torch.device(device)
        self.dtype = _DTYPES[precision]
        self.tables = [quality_scaled_tables(int(ref["jpeg_quality"])),
                       quality_scaled_tables(int(ref["paint_over_jpeg_quality"]))]
        self.headers = [jfif_headers(self.pad_w, self.stripe_h, qy, qc)
                        for qy, qc in self.tables]

    def _recip(self, qidx: int, rows: int, chroma: bool) -> torch.Tensor:
        t = self.tables[qidx][1 if chroma else 0].astype(np.float32)
        r = np.float32(1.0) / t
        return torch.from_numpy(np.broadcast_to(r, (rows, 8, 8)).copy()).to(
            self.device)

    def coefficients(self, frame: np.ndarray, qidx: int):
        """The padded frame's zigzag coefficients at table ``qidx``:
        Y [pad_h/8, pad_w/8, 64], Cb and Cr [pad_h/16, pad_w/16, 64]."""
        rgb = torch.from_numpy(padded(frame, self.pad_h, self.pad_w)).to(
            self.device)
        y, cb, cr = ycbcr(rgb, self.dtype)
        cb, cr = subsample(cb), subsample(cr)
        return (quantized(y, self._recip(qidx, self.pad_h // 8, False),
                          self.dtype),
                quantized(cb, self._recip(qidx, self.pad_h // 16, True),
                          self.dtype),
                quantized(cr, self._recip(qidx, self.pad_h // 16, True),
                          self.dtype))

    def stripe_jpeg(self, coeffs, s: int, qidx: int) -> bytes:
        y, cb, cr = coeffs
        yr, cr_rows = self.stripe_h // 8, self.stripe_h // 16
        scan = encode_scan_420(y[s * yr:(s + 1) * yr],
                               cb[s * cr_rows:(s + 1) * cr_rows],
                               cr[s * cr_rows:(s + 1) * cr_rows])
        return self.headers[qidx] + scan + EOI

    def changed_stripes(self, frame: np.ndarray,
                        prev: Optional[np.ndarray]) -> np.ndarray:
        """[S] bool: the stripes whose padded pixels differ from ``prev``
        (all, when there is no previous frame)."""
        if prev is None:
            return np.ones(self.n_stripes, bool)
        a = padded(frame, self.pad_h, self.pad_w)
        b = padded(prev, self.pad_h, self.pad_w)
        diff = (a != b).reshape(self.n_stripes, -1).any(axis=1)
        return diff

    def encode_frame(self, frame: np.ndarray, prev: Optional[np.ndarray],
                     frame_id: int) -> List[bytes]:
        """The messages of one frame as the profile sends it when no
        paint-over is due: every changed stripe at the profile's quality."""
        changed = self.changed_stripes(frame, prev)
        coeffs = self.coefficients(frame, 0)
        return [wire_stripe(frame_id, s * self.stripe_h,
                            self.stripe_jpeg(coeffs, s, 0))
                for s in range(self.n_stripes) if changed[s]]

    def judge_frame(self, frame: np.ndarray, prev: Optional[np.ndarray],
                    frame_id: int, messages: Sequence[bytes]) -> dict:
        """Judge one delivered frame. Returns ``{"ok", "stripes",
        "paintover", "why"}``."""
        changed = self.changed_stripes(frame, prev)
        got: Dict[int, bytes] = {}
        for m in messages:
            if len(m) < 6 or m[0] != 0x03:
                return self._bad("not a JPEG stripe message")
            fid, y0 = struct.unpack_from(">HH", m, 2)
            if fid != frame_id & 0xFFFF or y0 % self.stripe_h \
                    or y0 // self.stripe_h >= self.n_stripes:
                return self._bad(f"bad stripe header {fid} {y0}")
            s = y0 // self.stripe_h
            if s in got:
                return self._bad(f"stripe {s} twice")
            got[s] = m
        missing = [s for s in range(self.n_stripes) if changed[s]
                   and s not in got]
        if missing:
            return self._bad(f"changed stripes not delivered: {missing}")
        coeffs: Dict[int, tuple] = {}
        paint = 0
        for s, m in sorted(got.items()):
            jpeg = m[6:]
            qidx = next((i for i, h in enumerate(self.headers)
                         if jpeg.startswith(h)), None)
            if qidx is None:
                return self._bad(f"stripe {s}: headers of neither quality")
            if qidx == 0 and not changed[s]:
                return self._bad(f"stripe {s}: unchanged, yet sent at the "
                                 f"profile's quality")
            paint += qidx == 1
            if qidx not in coeffs:
                coeffs[qidx] = self.coefficients(frame, qidx)
            want = wire_stripe(frame_id, s * self.stripe_h,
                               self.stripe_jpeg(coeffs[qidx], s, qidx))
            if want != m:
                return self._bad(f"stripe {s}: bytes differ "
                                 f"({len(m)} delivered, {len(want)} expected)")
        return {"ok": True, "stripes": len(got), "paintover": paint,
                "why": ""}

    def judge_session(self, session: Session,
                      positions: Sequence[int]) -> List[dict]:
        """Judge the delivered frames at ``positions`` of the session: each
        against the frame the session encoded before it (a stripe-wise
        profile keeps no other state across frames)."""
        out = []
        for p in positions:
            e = session.encoded[p]
            prev = session.frame(session.encoded[p - 1].k) if p > 0 else None
            out.append(self.judge_frame(session.frame(e.k), prev, e.frame_id,
                                        e.messages or []))
        return out

    def encode_session(self, session: Session) -> List[List[bytes]]:
        """The messages of every frame the session encoded, each frame's
        changed stripes at the profile's quality."""
        out, prev = [], None
        for e in session.encoded:
            cur = session.frame(e.k)
            out.append(self.encode_frame(cur, prev, e.frame_id))
            prev = cur
        return out

    @staticmethod
    def _bad(why: str) -> dict:
        return {"ok": False, "stripes": 0, "paintover": 0, "why": why}


def make(config: dict, device="cpu", precision: str = "float32"):
    """The reference of ``config`` (the harness's entry point)."""
    return JpegReference(config, device=device, precision=precision)

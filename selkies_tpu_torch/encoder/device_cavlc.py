"""Device-side H.264 CAVLC entropy coding for P slices (counterpart of
``selkies_tpu/encoder/device_cavlc.py``).

Every CAVLC context of a P slice is data-parallel: the nC of a 4x4 block
is a count of its neighbours' nonzeros, and skip runs, MV prediction and
cbp are closed-form over the MV and level grids. Only the per-block
suffix_length adaptation is sequential, over at most 16 coefficients.

1. per-MB syntax (skip decision, mb_skip_run, mvd, cbp, mb_qp_delta) and
   per-residual-block CAVLC symbols go into fixed (bits, len) slot grids,
   each slot <= 32 bits;
2. the VLC tables (coeff_token / total_zeros / run_before, ITU-T H.264
   Tables 9-5..9-10) are one packed ``code << 5 | len`` table, looked up
   by integer indexing (the JAX package's one-hot matmul existed for the
   TPU's matrix unit; a gather is exact and has no float precision to
   pin);
3. each slot's bit offset in its stripe is a running sum of the lengths
   (int64, so nothing wraps), and its <= 32 bits land in at most two
   32-bit words, summed into the stripe's words (bit ranges never
   overlap, so the sum is the concatenation);
4. stripes compact back to back at word granularity behind a
   (t_bits, base, damage, overflow) head, so the host fetches ONE buffer.

The payload is the P slice after the slice header; the host prepends the
header bits, appends rbsp_trailing and escapes. The result is bit-exact
with ``native/cavlc.cpp``. Overflowed stripes (|level| beyond the escape
range, a unit past ``UNIT_WORDS``, or a stripe past ``max_stripe_bytes``)
are flagged and recoded on the host from the exact levels. This is plain
tensor code; a hand-written kernel for it is later work.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.h264_transform import const

MB = 16

#: 32-bit words per packed unit (512 bits).  The worst *legal* residual
#: block is ~476 bits (16 escape-coded levels + coeff_token + signs); a
#: MB header unit is ≤ ~90 bits.  Anything larger flags overflow.
UNIT_WORDS = 16

#: fixed per-stripe head: t_bits u32 LE, base_words u32 LE, damage, ovf,
#: 2 pad bytes
HEAD_BYTES = 12

# ---------------------------------------------------------------------------
# VLC tables (transcribed from native/cavlc.cpp — ITU-T H.264 §9.2)

_COEFF_TOKEN_LEN = np.array([
    [1, 0, 0, 0, 6, 2, 0, 0, 8, 6, 3, 0, 9, 8, 7, 5,
     10, 9, 8, 6, 11, 10, 9, 7, 13, 11, 10, 8, 13, 13, 11, 9,
     13, 13, 13, 10, 14, 14, 13, 11, 14, 14, 14, 13, 15, 15, 14, 14,
     15, 15, 15, 14, 16, 15, 15, 15, 16, 16, 16, 15, 16, 16, 16, 16,
     16, 16, 16, 16],
    [2, 0, 0, 0, 6, 2, 0, 0, 6, 5, 3, 0, 7, 6, 6, 4,
     8, 6, 6, 4, 8, 7, 7, 5, 9, 8, 8, 6, 11, 9, 9, 6,
     11, 11, 11, 7, 12, 11, 11, 9, 12, 12, 12, 11, 12, 12, 12, 11,
     13, 13, 13, 12, 13, 13, 13, 13, 13, 14, 13, 13, 14, 14, 14, 13,
     14, 14, 14, 14],
    [4, 0, 0, 0, 6, 4, 0, 0, 6, 5, 4, 0, 6, 5, 5, 4,
     7, 5, 5, 4, 7, 5, 5, 4, 7, 6, 6, 4, 7, 6, 6, 4,
     8, 7, 7, 5, 8, 8, 7, 6, 9, 8, 8, 7, 9, 9, 8, 8,
     9, 9, 9, 8, 10, 9, 9, 9, 10, 10, 10, 10, 10, 10, 10, 10,
     10, 10, 10, 10],
], np.int64)

_COEFF_TOKEN_BITS = np.array([
    [1, 0, 0, 0, 5, 1, 0, 0, 7, 4, 1, 0, 7, 6, 5, 3,
     7, 6, 5, 3, 7, 6, 5, 4, 15, 6, 5, 4, 11, 14, 5, 4,
     8, 10, 13, 4, 15, 14, 9, 4, 11, 10, 13, 12, 15, 14, 9, 12,
     11, 10, 13, 8, 15, 1, 9, 12, 11, 14, 13, 8, 7, 10, 9, 12,
     4, 6, 5, 8],
    [3, 0, 0, 0, 11, 2, 0, 0, 7, 7, 3, 0, 7, 10, 9, 5,
     7, 6, 5, 4, 4, 6, 5, 6, 7, 6, 5, 8, 15, 6, 5, 4,
     11, 14, 13, 4, 15, 10, 9, 4, 11, 14, 13, 12, 8, 10, 9, 8,
     15, 14, 13, 12, 11, 10, 9, 12, 7, 11, 6, 8, 9, 8, 10, 1,
     7, 6, 5, 4],
    [15, 0, 0, 0, 15, 14, 0, 0, 11, 15, 13, 0, 8, 12, 14, 12,
     15, 10, 11, 11, 11, 8, 9, 10, 9, 14, 13, 9, 8, 10, 9, 8,
     15, 14, 13, 13, 11, 14, 10, 12, 15, 10, 13, 12, 11, 14, 9, 12,
     8, 10, 13, 8, 13, 7, 9, 12, 9, 12, 11, 10, 5, 8, 7, 6,
     1, 4, 3, 2],
], np.int64)

_COEFF_TOKEN_CDC_LEN = np.array(
    [2, 0, 0, 0, 6, 1, 0, 0, 6, 6, 3, 0, 6, 7, 7, 6, 6, 8, 8, 7],
    np.int64)
_COEFF_TOKEN_CDC_BITS = np.array(
    [1, 0, 0, 0, 7, 1, 0, 0, 4, 6, 1, 0, 3, 3, 2, 5, 2, 3, 2, 0],
    np.int64)

_TOTAL_ZEROS_LEN = [
    [0],
    [1, 3, 3, 4, 4, 5, 5, 6, 6, 7, 7, 8, 8, 9, 9, 9],
    [3, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 6, 6, 6, 6],
    [4, 3, 3, 3, 4, 4, 3, 3, 4, 5, 5, 6, 5, 6],
    [5, 3, 4, 4, 3, 3, 3, 4, 3, 4, 5, 5, 5],
    [4, 4, 4, 3, 3, 3, 3, 3, 4, 5, 4, 5],
    [6, 5, 3, 3, 3, 3, 3, 3, 4, 3, 6],
    [6, 5, 3, 3, 3, 2, 3, 4, 3, 6],
    [6, 4, 5, 3, 2, 2, 3, 3, 6],
    [6, 6, 4, 2, 2, 3, 2, 5],
    [5, 5, 3, 2, 2, 2, 4],
    [4, 4, 3, 3, 1, 3],
    [4, 4, 2, 1, 3],
    [3, 3, 1, 2],
    [2, 2, 1],
    [1, 1],
]
_TOTAL_ZEROS_BITS = [
    [0],
    [1, 3, 2, 3, 2, 3, 2, 3, 2, 3, 2, 3, 2, 3, 2, 1],
    [7, 6, 5, 4, 3, 5, 4, 3, 2, 3, 2, 3, 2, 1, 0],
    [5, 7, 6, 5, 4, 3, 4, 3, 2, 3, 2, 1, 1, 0],
    [3, 7, 5, 4, 6, 5, 4, 3, 3, 2, 2, 1, 0],
    [5, 4, 3, 7, 6, 5, 4, 3, 2, 1, 1, 0],
    [1, 1, 7, 6, 5, 4, 3, 2, 1, 1, 0],
    [1, 1, 5, 4, 3, 3, 2, 1, 1, 0],
    [1, 1, 1, 3, 3, 2, 2, 1, 0],
    [1, 0, 1, 3, 2, 1, 1, 1],
    [1, 0, 1, 3, 2, 1, 1],
    [0, 1, 1, 2, 1, 3],
    [0, 1, 1, 1, 1],
    [0, 1, 1, 1],
    [0, 1, 1],
    [0, 1],
]

_TZ_CDC_LEN = [[0], [1, 2, 3, 3], [1, 2, 2, 0], [1, 1, 0, 0]]
_TZ_CDC_BITS = [[0], [1, 1, 1, 0], [1, 1, 0, 0], [1, 0, 0, 0]]

_RUN_BEFORE_LEN = [
    [0],
    [1, 1],
    [1, 2, 2],
    [2, 2, 2, 2],
    [2, 2, 2, 3, 3],
    [2, 2, 3, 3, 3, 3],
    [2, 3, 3, 3, 3, 3, 3],
    [3, 3, 3, 3, 3, 3, 3, 4, 5, 6, 7, 8, 9, 10, 11],
]
_RUN_BEFORE_BITS = [
    [0],
    [1, 0],
    [1, 1, 0],
    [3, 2, 1, 0],
    [3, 2, 1, 1, 0],
    [3, 2, 3, 2, 1, 0],
    [3, 0, 1, 3, 2, 5, 4],
    [7, 6, 5, 4, 3, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1],
]

#: coded_block_pattern me(v) mapping for Inter prediction (Table 9-4)
_CBP_INTER_BY_CODENUM = np.array([
    0, 16, 1, 2, 4, 8, 32, 3, 5, 10, 12, 15, 47, 7, 11, 13,
    14, 6, 9, 31, 35, 37, 42, 44, 33, 34, 36, 40, 39, 43, 45, 46,
    17, 18, 20, 24, 19, 21, 26, 28, 23, 27, 29, 30, 22, 25, 38, 41],
    np.int64)
_CBP_INTER_CODENUM = np.zeros(48, np.int32)
_CBP_INTER_CODENUM[_CBP_INTER_BY_CODENUM] = np.arange(48)

_ZIGZAG4 = np.array([0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15],
                    np.int32)

#: spec z-scan emission order of luma 4×4 blocks, as raster index r*4+c
_LUMA_SCAN = np.array([0, 1, 4, 5, 2, 3, 6, 7, 8, 9, 12, 13, 10, 11, 14, 15],
                      np.int32)

# packed (bits<<5 | len) table regions, one 1024-entry table
_TOK_BASE = 0           # 3 x 68 coeff_token classes
_TOKC_BASE = 204        # 20 chroma-DC coeff_token
_TZ_BASE = 224          # 16 x 16 total_zeros
_TZC_BASE = 480         # 4 x 4 chroma-DC total_zeros
_RB_BASE = 496          # 8 x 15 run_before


def _build_packed_lut() -> np.ndarray:
    lut = np.zeros(1024, np.int64)

    def put(base, i, bits, length):
        lut[base + i] = (int(bits) << 5) | int(length)

    for cls in range(3):
        for i in range(68):
            put(_TOK_BASE + cls * 68, i, _COEFF_TOKEN_BITS[cls][i],
                _COEFF_TOKEN_LEN[cls][i])
    for i in range(20):
        put(_TOKC_BASE, i, _COEFF_TOKEN_CDC_BITS[i], _COEFF_TOKEN_CDC_LEN[i])
    for t in range(16):
        row_l, row_b = _TOTAL_ZEROS_LEN[t], _TOTAL_ZEROS_BITS[t]
        for tz in range(len(row_l)):
            put(_TZ_BASE + t * 16, tz, row_b[tz], row_l[tz])
    for t in range(4):
        row_l, row_b = _TZ_CDC_LEN[t], _TZ_CDC_BITS[t]
        for tz in range(len(row_l)):
            put(_TZC_BASE + t * 4, tz, row_b[tz], row_l[tz])
    for zl in range(8):
        row_l, row_b = _RUN_BEFORE_LEN[zl], _RUN_BEFORE_BITS[zl]
        for run in range(len(row_l)):
            put(_RB_BASE + zl * 15, run, row_b[run], row_l[run])
    return lut


_PACKED_LUT = _build_packed_lut()
_CBP_CODENUM64 = _CBP_INTER_CODENUM.astype(np.int64)
_ZIGZAG4_64 = _ZIGZAG4.astype(np.int64)
_AC_SCAN64 = _ZIGZAG4_64[1:].copy()
_LUMA_SCAN64 = _LUMA_SCAN.astype(np.int64)
_B8_OF_BLOCK = np.array([(r // 2) * 2 + (c // 2)
                         for r in range(4) for c in range(4)], np.int64)
_W88 = np.array([[1, 2], [4, 8]], np.int64)
#: maxNumCoeff of the 24 luma + chroma AC blocks of an MB
_MAX_COEFF24 = np.array([16] * 16 + [15] * 8, np.int64)


def _lut(idx: torch.Tensor):
    """(bits, len) of the packed table at ``idx``, by integer gather."""
    packed = const(_PACKED_LUT, idx.device)[idx.long()]
    return packed >> 5, packed & 31


# ---------------------------------------------------------------------------
# exp-Golomb on device


def _ue_dev(v: torch.Tensor):
    """ue(v) -> (bits, len), int64. The bit length comes from frexp (exact:
    v is far below 2^53), capped where the JAX packer's count stops, so a
    flagged length past 32 bits reads the same there and here."""
    vp1 = v.to(torch.int64) + 1
    e = torch.frexp(vp1.to(torch.float64)).exponent.to(torch.int64)
    nb = (e - 1).clamp(max=16)       # bit_length - 1
    return vp1, 2 * nb + 1


def _se_dev(v: torch.Tensor):
    v = v.to(torch.int64)
    return _ue_dev(torch.where(v <= 0, -2 * v, 2 * v - 1))


# ---------------------------------------------------------------------------
# residual_block CAVLC symbols (§9.2), vectorized over blocks


def _code_blocks(scan: torch.Tensor, nC, max_coeff, chroma_dc: bool):
    """CAVLC symbols for B residual blocks.

    scan [B, K] coefficients in scan order; nC [B] (None for chroma DC);
    max_coeff the blocks' maxNumCoeff (an int, or [B]: a 15-coefficient
    chroma AC block rides a 16-wide scan with its last position zero).
    Returns (bits [B, NS], lens [B, NS], ovf [B]) with NS = 2*K + 2 slots:
    [coeff_token, t1 signs, level_0.._{K-1} (reverse order), total_zeros,
    run_before_0.._{K-2}]. Lens include the token even for total == 0;
    callers gate whole blocks by zeroing lens."""
    K = scan.shape[1]
    dev = scan.device
    scan = scan.to(torch.int64)
    nz = scan != 0
    t = nz.sum(-1)
    kk = torch.arange(K, device=dev)

    # positions of the nonzeros from the END of the scan: pos_rev[:, k] is
    # the k-th nonzero counted backwards (0 past the last one)
    key = torch.where(nz, kk, -1)
    pos_rev = torch.sort(key, dim=1, descending=True).values
    live = kk[None, :] < t[:, None]
    pos_rev = torch.where(live, pos_rev, 0)
    vals_rev = torch.where(live, scan.gather(1, pos_rev), 0)

    # trailing ones: leading run of |v| == 1 in reverse order, capped at 3
    isone = vals_rev.abs() == 1
    run1 = isone[:, 0]
    t1 = run1.to(torch.int64)
    for k in range(1, min(3, K)):
        run1 = run1 & isone[:, k]
        t1 = t1 + run1.to(torch.int64)

    # ---- coeff_token ------------------------------------------------------
    tok_idx = t * 4 + t1
    if chroma_dc:
        token_bits, token_len = _lut(_TOKC_BASE + tok_idx)
    else:
        nC = nC.to(torch.int64)
        cls = torch.where(nC < 2, 0, torch.where(nC < 4, 1, 2))
        tb, tl = _lut(_TOK_BASE + cls * 68 + tok_idx)
        flc = torch.where(t == 0, 3, ((t - 1) << 2) | t1)
        token_bits = torch.where(nC >= 8, flc, tb)
        token_len = torch.where(nC >= 8, 6, tl)

    # ---- trailing-one signs (one slot, MSB-first emission order) ----------
    within = kk[None, :] < t1[:, None]
    sign = ((vals_rev < 0) & within).to(torch.int64)
    shift = (t1[:, None] - 1 - kk[None, :]).clamp(0, 31)
    sign_bits = (sign << shift).sum(1)

    # ---- levels (reverse order). Only suffix_length is sequential: a loop
    # of K short steps finds each level's, then every level codes at once
    emit = (kk[None, :] >= t1[:, None]) & (kk[None, :] < t[:, None])
    mag = vals_rev.abs()
    lc = 2 * (mag - 1) + (vals_rev < 0).to(torch.int64)
    lc = lc - torch.where((kk[None, :] == t1[:, None])
                          & (t1[:, None] < 3), 2, 0)
    sl = torch.where((t > 10) & (t1 < 3), 1, 0)
    sls: List[torch.Tensor] = []
    for k in range(K):
        sls.append(sl)
        s1 = sl.clamp(min=1)
        s1 = s1 + ((mag[:, k] > (3 << (s1 - 1))) & (s1 < 6)).to(torch.int64)
        sl = torch.where(emit[:, k], s1, sl)
    sl = torch.stack(sls, dim=1)                           # [B, K]

    # suffix_length == 0 encoding
    esc0 = lc >= 30
    b0 = torch.where(lc < 14, 1,
                     torch.where(~esc0, (1 << 4) | (lc - 14),
                                 (1 << 12) | ((lc - 30) & 0xFFF)))
    l0 = torch.where(lc < 14, lc + 1, torch.where(~esc0, 19, 28))
    o0 = lc >= 30 + 4096
    # suffix_length > 0 encoding
    th = 15 << sl
    esc1 = lc >= th
    b1 = torch.where(~esc1, (1 << sl) | (lc & ((1 << sl) - 1)),
                     (1 << 12) | ((lc - th) & 0xFFF))
    l1 = torch.where(~esc1, (lc >> sl) + 1 + sl, 28)
    o1 = lc >= th + 4096
    zero_sl = sl == 0
    ovf = (emit & torch.where(zero_sl, o0, o1)).any(1)
    lvl_bits = torch.where(emit, torch.where(zero_sl, b0, b1), 0)
    lvl_lens = torch.where(emit, torch.where(zero_sl, l0, l1), 0)

    # ---- total_zeros ------------------------------------------------------
    tz = pos_rev[:, 0] + 1 - t
    emit_tz = (t > 0) & (t < max_coeff)
    if chroma_dc:
        tzi = _TZC_BASE + t.clamp(0, 3) * 4 + tz.clamp(0, 3)
    else:
        tzi = _TZ_BASE + t.clamp(0, 15) * 16 + tz.clamp(0, 15)
    tzb, tzl = _lut(tzi)
    tz_bits = torch.where(emit_tz, tzb, 0)
    tz_len = torch.where(emit_tz, tzl, 0)

    # ---- run_before (reverse order; zeros_left_i = p_i - i closed form) ---
    k1 = kk[None, :K - 1]
    zeros_left = pos_rev[:, :-1] - (t[:, None] - 1 - k1)
    run = pos_rev[:, :-1] - pos_rev[:, 1:] - 1
    emit_rb = (k1 <= t[:, None] - 2) & (zeros_left > 0)
    rbb, rbl = _lut(_RB_BASE + zeros_left.clamp(0, 7) * 15 + run.clamp(0, 14))
    rb_bits = torch.where(emit_rb, rbb, 0)
    rb_lens = torch.where(emit_rb, rbl, 0)

    bits = torch.cat([token_bits[:, None], sign_bits[:, None], lvl_bits,
                      tz_bits[:, None], rb_bits], dim=1)
    lens = torch.cat([token_len[:, None], t1[:, None], lvl_lens,
                      tz_len[:, None], rb_lens], dim=1)
    return bits, lens, ovf


# ---------------------------------------------------------------------------
# slot grids -> stripe words


def _stripe_words(bits: torch.Tensor, lens: torch.Tensor, V: int):
    """Concatenate each stripe's slots into its bitstream words.

    bits, lens [S, N] int64 (slots in emission order, len <= 32 where the
    stripe is not flagged). Returns (words [S, V] int64 holding 32-bit
    MSB-first words, t_bits [S]). A slot at bit offset ``off`` fills word
    ``off >> 5`` and, when it straddles, the next one; words past V are
    dropped (the stripe is then flagged by its t_bits)."""
    S = bits.shape[0]
    off = torch.cumsum(lens, dim=1) - lens
    t_bits = lens.sum(1)
    j0 = off >> 5
    sh = 32 - (off & 31) - lens                   # in [-31, 31] for len <= 32
    safe = torch.where(lens > 0, bits, 0)
    mask32 = 0xFFFFFFFF
    c0 = torch.where(sh >= 0, safe << sh.clamp(0, 63),
                     safe >> (-sh).clamp(0, 63)) & mask32
    c1 = torch.where(sh < 0, (safe << (32 + sh).clamp(0, 63)) & mask32, 0)
    words = torch.zeros((S, V + 1), dtype=torch.int64, device=bits.device)
    words.scatter_add_(1, j0.clamp(max=V), c0)
    words.scatter_add_(1, (j0 + 1).clamp(max=V), c1)
    return words[:, :V], t_bits


# ---------------------------------------------------------------------------
# P-slice payload pack


def default_max_stripe_bytes(mb_w: int, mb_h: int) -> int:
    """Per-stripe payload capacity: 256 B/MB of headroom (streaming QPs
    measure ~27 B/MB mean, paint-over ~4x that), pow2, >= 16 KB."""
    n = 16384
    while n < 256 * mb_w * mb_h:
        n <<= 1
    return n


def _nc_from_grid(grid: torch.Tensor) -> torch.Tensor:
    """nC of every 4x4 block from its left/top neighbours' totalCoeff
    (-1 = unavailable) over [S, rows, cols]."""
    left = F.pad(grid, (1, 0), value=-1)[:, :, :-1]
    top = F.pad(grid, (0, 0, 1, 0), value=-1)[:, :-1]
    both = (left >= 0) & (top >= 0)
    return torch.where(both, (left + top + 1) >> 1,
                       torch.where(left >= 0, left,
                                   torch.where(top >= 0, top, 0)))


def _any(x: torch.Tensor, start: int) -> torch.Tensor:
    """x.any() over every axis from ``start`` on."""
    return x.flatten(start).any(-1)


def pack_p_frame_words(mv, luma, chroma_dc, chroma_ac, update, *,
                       mb_w: int, mb_h: int, max_stripe_bytes: int,
                       frames: int = 1):
    """Device CAVLC over P frames' level tensors.

    mv [S, n, 2] (dy, dx); luma [S, n, 16, 4, 4] (raster 4x4 grid);
    chroma_dc [S, n, 2, 2, 2]; chroma_ac [S, n, 2, 4, 4, 4] (position 0
    zeroed); update [S] bool — stripes outside the mask pack nothing. The
    S axis holds ``frames`` frames' stripes, frame-major: every stripe is
    coded on its own, and each frame's stripes compact on their own.

    Returns (words [frames, S/frames*V] int64 of 32-bit values — each
    frame's per-stripe P-slice payloads, MSB-first, compacted back to
    back; t_bits [S]; base_words [S], from the start of its frame's
    words; overflow [S] bool), V = max_stripe_bytes / 4."""
    S = mv.shape[0]
    n = mb_w * mb_h
    V = max_stripe_bytes // 4
    dev = mv.device
    i64 = torch.int64

    mv = mv.to(i64)
    luma = luma.to(i64)
    chroma_dc = chroma_dc.to(i64)
    chroma_ac = chroma_ac.to(i64)
    upd = update.to(torch.bool)

    # ---- per-block totalCoeff and cbp ------------------------------------
    lt = (luma != 0).sum((-1, -2))                         # [S, n, 16]
    cact = (chroma_ac != 0).sum((-1, -2))                  # [S, n, 2, 4]
    cdct = (chroma_dc != 0).sum((-1, -2))                  # [S, n, 2]

    nz88 = _any((lt > 0).reshape(S, n, 2, 2, 2, 2)
                .permute(0, 1, 2, 4, 3, 5), 4)             # [S, n, 2, 2]
    cbp_luma = (nz88.to(i64) * const(_W88, dev)).sum((-1, -2))
    has_cac = _any(cact > 0, 2)
    has_cdc = _any(cdct > 0, 2)
    cbp_chroma = torch.where(has_cac, 2, torch.where(has_cdc, 1, 0))
    cbp = cbp_luma | (cbp_chroma << 4)
    any_coeff = cbp > 0                                    # [S, n]

    # ---- MV prediction, skip decision, mvd (§8.4.1) ----------------------
    mvg = mv.reshape(S, mb_h, mb_w, 2)
    a = F.pad(mvg, (0, 0, 1, 0))[:, :, :-1]                # left
    b = F.pad(mvg, (0, 0, 0, 0, 1, 0))[:, :-1]             # top
    c_tr = F.pad(mvg, (0, 0, 0, 1, 1, 0))[:, :-1, 1:]
    d_tl = F.pad(mvg, (0, 0, 1, 0, 1, 0))[:, :-1, :-1]
    col = torch.arange(mb_w, device=dev)[None, None, :]
    row = torch.arange(mb_h, device=dev)[None, :, None]
    a_av = col > 0
    b_av = row > 0
    ctr_av = (row > 0) & (col + 1 < mb_w)
    d_av = (row > 0) & (col > 0)
    c = torch.where(ctr_av[..., None], c_tr,
                    torch.where(d_av[..., None], d_tl, 0))
    c_av = ctr_av | d_av

    med = torch.maximum(torch.minimum(a, b),
                        torch.minimum(torch.maximum(a, b), c))
    only_a = a_av & ~b_av & ~c_av
    pred = torch.where(only_a[..., None], a, med)          # [S, mh, mw, 2]

    a_zero = (a == 0).all(-1)
    b_zero = (b == 0).all(-1)
    skip_mv = torch.where((~a_av | ~b_av | a_zero | b_zero)[..., None],
                          0, pred)
    skip = ~any_coeff.reshape(S, mb_h, mb_w) & (mvg == skip_mv).all(-1)
    coded = (~skip).reshape(S, n)
    mvd = ((mvg - pred) * 4).reshape(S, n, 2)              # quarter-pel

    # ---- mb_skip_run + trailing run (prefix max over raster order) -------
    idx = torch.arange(n, device=dev)[None, :]
    run_max = torch.cummax(torch.where(coded, idx, -1), dim=1).values
    prev_coded = F.pad(run_max[:, :-1], (1, 0), value=-1)
    skip_run = idx - prev_coded - 1
    tail_run = n - 1 - run_max[:, -1]                      # [S]

    # ---- header unit slots [S, n, 6] -------------------------------------
    sr_b, sr_l = _ue_dev(skip_run)
    mx_b, mx_l = _se_dev(mvd[..., 1])                      # x first
    my_b, my_l = _se_dev(mvd[..., 0])
    cb_b, cb_l = _ue_dev(const(_CBP_CODENUM64, dev)[cbp])
    one = torch.ones_like(sr_b)
    hdr_bits = torch.stack([sr_b, one, mx_b, my_b, cb_b, one], dim=-1)
    hdr_lens = torch.stack([sr_l, one, mx_l, my_l, cb_l,
                            any_coeff.to(i64)], dim=-1)
    gate_mb = (coded & upd[:, None]).to(i64)
    hdr_lens = hdr_lens * gate_mb[..., None]

    # ---- nC grids --------------------------------------------------------
    lgrid = lt.reshape(S, mb_h, mb_w, 4, 4).permute(0, 1, 3, 2, 4) \
        .reshape(S, mb_h * 4, mb_w * 4)
    nc_l = _nc_from_grid(lgrid).reshape(S, mb_h, 4, mb_w, 4) \
        .permute(0, 1, 3, 2, 4).reshape(S, n, 16)

    def _nc_chroma(totals):                                # [S, n, 4]
        grid = totals.reshape(S, mb_h, mb_w, 2, 2).permute(0, 1, 3, 2, 4) \
            .reshape(S, mb_h * 2, mb_w * 2)
        return _nc_from_grid(grid).reshape(S, mb_h, 2, mb_w, 2) \
            .permute(0, 1, 3, 2, 4).reshape(S, n, 4)

    nc_c = torch.stack([_nc_chroma(cact[:, :, 0]),
                        _nc_chroma(cact[:, :, 1])], dim=2)  # [S, n, 2, 4]

    # ---- residual units: 16 luma and 8 chroma AC blocks per MB in one
    # pass (chroma AC padded to 16 positions), then the chroma DC pairs
    scan24 = torch.cat([
        luma.reshape(S, n, 16, 16).index_select(-1, const(_ZIGZAG4_64, dev)),
        F.pad(chroma_ac.reshape(S, n, 8, 16)
              .index_select(-1, const(_AC_SCAN64, dev)), (0, 1)),
    ], dim=2)                                              # [S, n, 24, 16]
    nc24 = torch.cat([nc_l, nc_c.reshape(S, n, 8)], dim=2)
    bl_bits, bl_lens, bl_ovf = _code_blocks(
        scan24.reshape(-1, 16), nc24.reshape(-1),
        const(_MAX_COEFF24, dev).expand(S, n, 24).reshape(-1), False)
    SLOT = 2 * 16 + 2                                      # 34 = the widest
    lu_gate = ((cbp_luma[..., None] >> const(_B8_OF_BLOCK, dev)) & 1) \
        * gate_mb[..., None]
    ca_gate = (cbp_chroma == 2).to(i64) * gate_mb
    gate24 = torch.cat([lu_gate, ca_gate[..., None].expand(S, n, 8)], dim=2)
    bl_bits = bl_bits.reshape(S, n, 24, SLOT)
    bl_lens = bl_lens.reshape(S, n, 24, SLOT) * gate24[..., None]
    bl_ovf = _any(bl_ovf.reshape(S, n, 24) & (gate24 > 0), 1)

    cd_bits, cd_lens, cd_ovf = _code_blocks(
        chroma_dc.reshape(-1, 4), None, 4, True)           # raster = scan
    NSC = 2 * 4 + 2
    cd_bits = cd_bits.reshape(S, n, 2, NSC)
    cd_gate = (cbp_chroma >= 1).to(i64) * gate_mb
    cd_lens = cd_lens.reshape(S, n, 2, NSC) * cd_gate[..., None, None]
    cd_ovf = _any(cd_ovf.reshape(S, n, 2) & (cd_gate > 0)[..., None], 1)

    # ---- unit sequence: [hdr, luma x16 (z-scan), cdc x2, cac x8] per MB --
    def padslots(x, ns):
        return F.pad(x, (0, SLOT - ns))

    lorder = const(_LUMA_SCAN64, dev)
    u_bits = torch.cat([padslots(hdr_bits[:, :, None, :], 6),
                        bl_bits[:, :, :16].index_select(2, lorder),
                        padslots(cd_bits, NSC), bl_bits[:, :, 16:]],
                       dim=2)                              # [S, n, 27, SLOT]
    u_lens = torch.cat([padslots(hdr_lens[:, :, None, :], 6),
                        bl_lens[:, :, :16].index_select(2, lorder),
                        padslots(cd_lens, NSC), bl_lens[:, :, 16:]],
                       dim=2)
    tr_b, tr_l = _ue_dev(tail_run)
    tail_bits = F.pad(tr_b[:, None], (0, SLOT - 1))
    tail_lens = F.pad((tr_l * (tail_run > 0) * upd)[:, None], (0, SLOT - 1))

    U = n * 27 + 1
    all_bits = torch.cat([u_bits.reshape(S, n * 27, SLOT),
                          tail_bits[:, None]], dim=1)
    all_lens = torch.cat([u_lens.reshape(S, n * 27, SLOT),
                          tail_lens[:, None]], dim=1)

    # ---- words, stripe flags, compaction ----------------------------------
    # a unit past UNIT_WORDS flags its stripe, as in the JAX packer (whose
    # per-unit words hold at most that many)
    unit_ovf = _any(all_lens.sum(-1) > 32 * UNIT_WORDS, 1)
    words_stripe, t_bits = _stripe_words(
        all_bits.reshape(S, U * SLOT), all_lens.reshape(S, U * SLOT), V)

    # each frame's stripes back to back: a stripe's base is the running
    # sum of the word counts before it in its frame
    fs = S // frames
    wc = torch.clamp((t_bits + 31) // 32, max=V).reshape(frames, fs)
    base_words = F.pad(torch.cumsum(wc, 1)[:, :-1], (1, 0))
    j = torch.arange(fs * V, device=dev).repeat(frames, 1)
    sidx = (torch.searchsorted(base_words, j, right=True) - 1) \
        .clamp(0, fs - 1)
    src = sidx * V + (j - base_words.gather(1, sidx)).clamp(0, V - 1)
    valid = j < (base_words[:, -1] + wc[:, -1])[:, None]
    words = torch.where(valid, words_stripe.reshape(frames, fs * V)
                        .gather(1, src), 0)

    # a slot may span at most 2 words (len <= 32); exp-Golomb header slots
    # are the only lengths not bounded by a table — flag the stripe rather
    # than corrupt if one exceeds 32 bits
    hdr_slot_ovf = _any(hdr_lens > 32, 1)
    overflow = (bl_ovf | cd_ovf | hdr_slot_ovf
                | (t_bits > 32 * V) | unit_ovf) & upd
    return words, t_bits, base_words.reshape(-1), overflow


def _le4(x: torch.Tensor) -> torch.Tensor:
    x = x.to(torch.int64) & 0xFFFFFFFF
    return torch.stack([(x >> (8 * i)) & 0xFF for i in range(4)],
                       dim=1).to(torch.uint8)


def pack_p_frame(mv, luma, chroma_dc, chroma_ac, damage, update, *,
                 mb_w: int, mb_h: int, max_stripe_bytes: int,
                 frames: Optional[int] = None):
    """Fetchable uint8 buffer: [S, HEAD_BYTES] head + big-endian payload.

    Head per stripe: t_bits u32 LE, base_words u32 LE, damage u8,
    overflow u8, 2 pad bytes. Payload: the compacted words MSB-first, so
    byte i of a stripe's payload carries its bits 8i..8i+7.

    ``frames=B`` codes B frames' stripes at once (the S axis frame-major)
    and returns [B, L]: row b is the buffer frame b alone would give."""
    words, t_bits, base_words, overflow = pack_p_frame_words(
        mv, luma, chroma_dc, chroma_ac, update,
        mb_w=mb_w, mb_h=mb_h, max_stripe_bytes=max_stripe_bytes,
        frames=frames or 1)
    S = t_bits.shape[0]
    B = words.shape[0]
    head = torch.cat([
        _le4(t_bits), _le4(base_words),
        damage.to(torch.uint8)[:, None], overflow.to(torch.uint8)[:, None],
        torch.zeros((S, 2), dtype=torch.uint8, device=words.device),
    ], dim=1)
    payload = torch.stack([(words >> 24) & 0xFF, (words >> 16) & 0xFF,
                           (words >> 8) & 0xFF, words & 0xFF],
                          dim=-1).to(torch.uint8)
    buf = torch.cat([head.reshape(B, -1), payload.reshape(B, -1)], dim=1)
    return buf if frames else buf[0]


# ---------------------------------------------------------------------------
# host-side glue: slice header + payload + trailing + EP escape -> NAL


def parse_cavlc_head(host: np.ndarray, n_stripes: int):
    """(t_bits, base_words, damage, ovf) from a fetched head prefix."""
    h = np.asarray(host[:HEAD_BYTES * n_stripes], np.uint8) \
        .reshape(n_stripes, HEAD_BYTES)
    w = (1 << (8 * np.arange(4, dtype=np.int64)))
    t_bits = (h[:, 0:4].astype(np.int64) * w).sum(1)
    base_words = (h[:, 4:8].astype(np.int64) * w).sum(1)
    return t_bits, base_words, h[:, 8] != 0, h[:, 9] != 0


def _p_slice_header_bits(qp: int, frame_num: int) -> List[int]:
    """Bit list for the P slice header native/cavlc.cpp writes
    (deblocking disabled, single slice, first_mb 0)."""
    bits: List[int] = []

    def u(v, nb):
        for i in range(nb - 1, -1, -1):
            bits.append((v >> i) & 1)

    def ue(v):
        vp1 = v + 1
        nb = vp1.bit_length() - 1
        u(0, nb)
        u(vp1, nb + 1)

    def se(v):
        ue(-2 * v if v <= 0 else 2 * v - 1)

    ue(0)                       # first_mb_in_slice
    ue(5)                       # slice_type: P (all)
    ue(0)                       # pps id
    u(frame_num & 0xF, 4)
    u(0, 1)                     # num_ref_idx_active_override
    u(0, 1)                     # ref_pic_list_modification_l0
    u(0, 1)                     # adaptive_ref_pic_marking
    se(qp - 26)                 # slice_qp_delta
    ue(1)                       # disable_deblocking_filter_idc
    return bits


def _ep_escape(rbsp: np.ndarray) -> bytes:
    """Emulation-prevention escaping with the sequential reset semantics
    (an accepted escape restarts the zero-run count), vectorized over
    the rare candidate positions."""
    a = np.asarray(rbsp, np.uint8)
    if len(a) < 3:
        return a.tobytes()
    z = a == 0
    cand = np.flatnonzero(z[:-2] & z[1:-1] & (a[2:] <= 3)) + 2
    if cand.size == 0:
        return a.tobytes()
    accepted = []
    last = -10
    for j in cand:
        if j == last + 1:       # inserted 0x03 reset the zero run
            continue
        accepted.append(j)
        last = j
    return np.insert(a, accepted, 3).tobytes()


def assemble_p_slice(payload: np.ndarray, nbits: int, qp: int,
                     frame_num: int) -> bytes:
    """One Annex-B P-slice NAL from a device-packed payload.

    payload: uint8 big-endian bit buffer (≥ ceil(nbits/8) bytes, bits
    past ``nbits`` zero).  Bit-exact with h264_encode_picture's P path.
    """
    hdr = _p_slice_header_bits(qp, frame_num)
    k = len(hdr)
    npay = (nbits + 7) // 8
    pb = np.asarray(payload[:npay], np.uint8)
    total_bits = k + nbits + 1                  # + rbsp stop bit
    nbytes = (total_bits + 7) // 8
    out = np.zeros(nbytes + 1, np.uint8)
    hb = np.packbits(np.asarray(hdr, np.uint8))
    out[:len(hb)] = hb
    base, s = k // 8, k % 8
    if s == 0:
        out[base:base + npay] = pb
    else:
        out[base:base + npay] |= pb >> s
        out[base + 1:base + 1 + npay] |= (
            (pb.astype(np.uint16) << (8 - s)) & 0xFF).astype(np.uint8)
    stop = k + nbits
    out[stop >> 3] |= 0x80 >> (stop & 7)
    return (b"\x00\x00\x00\x01" + bytes(((3 << 5) | 1,))
            + _ep_escape(out[:nbytes]))


def payload_slice(host: np.ndarray, n_stripes: int,
                  base_words: np.ndarray, t_bits: np.ndarray,
                  i: int) -> Tuple[np.ndarray, int]:
    """(payload bytes, nbits) for stripe ``i`` of a fetched buffer."""
    start = HEAD_BYTES * n_stripes + int(base_words[i]) * 4
    nbits = int(t_bits[i])
    return host[start:start + ((nbits + 31) // 32) * 4], nbits

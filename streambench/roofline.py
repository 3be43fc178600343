"""The work the hand-written kernels must do, from shapes alone, and the
peaks of the chip it is held against.

A roofline share is the least time the chip could take for a launch,
divided by the time the launch took (a kernel's mean time per launch from
the device trace). Nothing here reads a compiled kernel: a kernel that
issues fewer instructions does the same work.
"""

from __future__ import annotations

#: NVIDIA H100 SXM5 80GB HBM3, NVIDIA's data sheet: 3.35 TB/s of HBM3
#: bandwidth, at the card's full 700 W power limit (a card set below it
#: runs slower under load; the run reports the card's ``power.limit``).
HBM_BYTES_PER_S = 3.35e12

#: Byte comparisons a second that no implementation of a sum of absolute
#: differences can exceed on that card. Each comparison |a - b| of two
#: pixels is one operation on 8-bit data. The card's fastest 8-bit rate
#: is its tensor cores' dense int8 rate, 1,979 TOP/s (data sheet; one
#: multiply and one add counted as two operations), and no unit of the
#: card performs 8-bit operations faster. So 1,979e12 comparisons a
#: second bounds every implementation, whatever instructions it uses.
INT8_OPS_PER_S = 1979e12


def dct8_bytes(n_sessions: int, pad_h: int, pad_w: int, nq: int = 2) -> int:
    """Bytes one ``dct8_quant_zigzag`` launch of a JPEG lane must move:
    the float32 Y plane ``[N*pad_h, pad_w]`` and the two chroma planes
    ``[N*pad_h/2, pad_w/2]`` read once, their int16 zigzag coefficients
    (as many as pixels) written once, and each plane's reciprocal tables
    ``[nq, 8, 8]`` float32 and int32 row index (one per 8 rows) read once."""
    y_px = n_sessions * pad_h * pad_w
    c_px = n_sessions * (pad_h // 2) * (pad_w // 2)
    planes = (y_px + 2 * c_px) * (4 + 2)
    tables = 3 * nq * 64 * 4
    rows = (n_sessions * pad_h // 8 + 2 * n_sessions * pad_h // 16) * 4
    return planes + tables + rows


def dct8_bound_s(n_sessions: int, pad_h: int, pad_w: int) -> float:
    """The least time a launch can take: its bytes at the HBM rate (its
    arithmetic, about 2 x 8 multiply-adds a coefficient, is far below the
    card's float32 rate)."""
    return dct8_bytes(n_sessions, pad_h, pad_w) / HBM_BYTES_PER_S


def me_mc_comparisons(stripes: int, stripe_h: int, width: int,
                      search: int = 12) -> int:
    """Byte comparisons one ``me_mc_stripes`` launch must make: every luma
    pixel of every 16x16 macroblock of ``stripes`` stripes
    ``[stripes, stripe_h, width]`` against each of the (2*search + 1)^2
    integer offsets of the full search."""
    return stripes * stripe_h * width * (2 * search + 1) ** 2


def me_mc_bound_s(stripes: int, stripe_h: int, width: int,
                  search: int = 12) -> float:
    return me_mc_comparisons(stripes, stripe_h, width, search) \
        / INT8_OPS_PER_S


def share_pct(bound_s: float, took_s: float) -> float:
    """The roofline share in percent (not clipped: a reading above 100%
    means the work or the time was counted wrong)."""
    return 100.0 * bound_s / took_s

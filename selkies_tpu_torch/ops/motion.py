"""Block motion estimation + compensation for the H.264 profile.

Counterpart of ``selkies_tpu/ops/motion.py``. :func:`full_search_mc` is the
plain PyTorch version of the motion-search kernel (``ops/me_mc.py``): an
exhaustive integer-pel search over every (dy, dx) in [-search, search]^2
per 16x16 macroblock, visited in the sorted order of :func:`_offsets` and
keeping the earliest global minimum, then the winning luma prediction and
the §8.4.2.2.2 chroma bilinear.

Edge semantics: the reference is replicate-padded by the search radius;
slicing the padded plane at an offset equals clamping the source
coordinates to the plane (H.264's decoder-side edge extension, §8.4.2.2.1),
which is how the predictions are gathered here. Every plane is one stripe,
an independent sequence, so the clamp never crosses into the next stripe.
"""

from __future__ import annotations

import numpy as np
import torch

MB = 16


def _clamped(n: int, lo: int, hi: int, device) -> torch.Tensor:
    return torch.arange(lo, hi, device=device).clamp(0, n - 1)


def pad_replicate(plane: torch.Tensor, r: int) -> torch.Tensor:
    """Replicate-pad the last two axes by r (any dtype)."""
    h, w = plane.shape[-2:]
    rows = _clamped(h, -r, h + r, plane.device)
    cols = _clamped(w, -r, w + r, plane.device)
    return plane.index_select(-2, rows).index_select(-1, cols)


def _offsets(search: int) -> np.ndarray:
    """All (dy, dx) in [-search, search]^2, zero offset first.

    Ties go to the earliest offset in this order: (0, 0) first (cheaper
    MVDs, skip eligibility), then by |dy|+|dx|, |dy|, |dx| — the sort key
    of the JAX package, which fixes the winners bit for bit."""
    offs = [(dy, dx)
            for dy in range(-search, search + 1)
            for dx in range(-search, search + 1)]
    offs.sort(key=lambda o: (abs(o[0]) + abs(o[1]), abs(o[0]), abs(o[1])))
    return np.asarray(offs, np.int32)


def _mb_field(mv: torch.Tensor, cell: int, h: int, w: int):
    """Per-MB (dy, dx) of mv (..., nby, nbx, 2) expanded to (..., h, w)
    pixels of ``cell``-sized blocks."""
    dy = mv[..., 0].repeat_interleave(cell, -2).repeat_interleave(cell, -1)
    dx = mv[..., 1].repeat_interleave(cell, -2).repeat_interleave(cell, -1)
    return dy[..., :h, :w], dx[..., :h, :w]


def _gather(plane: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor):
    """plane[..., ys, xs] for per-pixel coordinates of plane's shape."""
    h, w = plane.shape[-2:]
    flat = plane.reshape(*plane.shape[:-2], h * w)
    idx = (ys * w + xs).reshape(*ys.shape[:-2], -1)
    return flat.gather(-1, idx.long()).reshape(ys.shape)


def mc_predict(ref, ref_cb, ref_cr, mv):
    """Motion-compensated predictions for a per-MB integer MV field.

    ref (..., h, w) and ref_cb/ref_cr (..., h/2, w/2) uint8; mv
    (..., h/16, w/16, 2) int (dy, dx). Luma copies the clamped reference;
    chroma is the §8.4.2.2.2 bilinear with {0, 4}/8 weights, with the
    arithmetic ``>>`` and ``&`` of the JAX package. Returns uint8 planes."""
    h, w = ref.shape[-2:]
    hc, wc = ref_cb.shape[-2:]
    dev = ref.device
    dy, dx = _mb_field(mv.to(torch.int32), MB, h, w)
    yy = torch.arange(h, device=dev, dtype=torch.int32)[:, None]
    xx = torch.arange(w, device=dev, dtype=torch.int32)[None, :]
    pred_y = _gather(ref, (yy + dy).clamp(0, h - 1), (xx + dx).clamp(0, w - 1))

    cdy, cdx = _mb_field(mv.to(torch.int32), MB // 2, hc, wc)
    iy, ix = cdy >> 1, cdx >> 1
    yf, xf = (cdy & 1) * 4, (cdx & 1) * 4
    yc = torch.arange(hc, device=dev, dtype=torch.int32)[:, None] + iy
    xc = torch.arange(wc, device=dev, dtype=torch.int32)[None, :] + ix
    y0, y1 = yc.clamp(0, hc - 1), (yc + 1).clamp(0, hc - 1)
    x0, x1 = xc.clamp(0, wc - 1), (xc + 1).clamp(0, wc - 1)
    preds = []
    for cp in (ref_cb, ref_cr):
        cpi = cp.to(torch.int32)
        tl, tr = _gather(cpi, y0, x0), _gather(cpi, y0, x1)
        bl, br = _gather(cpi, y1, x0), _gather(cpi, y1, x1)
        acc = ((8 - xf) * (8 - yf) * tl + xf * (8 - yf) * tr
               + (8 - xf) * yf * bl + xf * yf * br + 32) >> 6
        preds.append(acc.to(torch.uint8))
    return pred_y, preds[0], preds[1]


def sad_per_mb(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., h, w) planes -> (..., h/16, w/16) int32 sums of |a - b|."""
    h, w = a.shape[-2:]
    d = (a.to(torch.int32) - b.to(torch.int32)).abs()
    return d.reshape(*d.shape[:-2], h // MB, MB, w // MB, MB).sum(
        (-3, -1), dtype=torch.int32)


def full_search_mc(cur, ref, ref_cb, ref_cr, *, search: int = 12):
    """Exhaustive ME + luma/chroma MC: the plain version of ``me_mc``.

    cur/ref: (..., h, w) uint8 luma; ref_cb/ref_cr: (..., h/2, w/2) uint8.
    Offsets are visited in :func:`_offsets` order and a strict ``<`` keeps
    the earliest global minimum, so ties go to the lowest rank. Returns
    (mv (..., h/16, w/16, 2) int32, pred_y, pred_cb, pred_cr uint8)."""
    h, w = cur.shape[-2:]
    offs = _offsets(search)
    ref_pad = pad_replicate(ref, search).to(torch.int16)
    cur_i = cur.to(torch.int16)
    lead = cur.shape[:-2]
    best_sad = torch.full(lead + (h // MB, w // MB), 2 ** 30,
                          dtype=torch.int32, device=cur.device)
    best_idx = torch.zeros(best_sad.shape, dtype=torch.int64,
                           device=cur.device)
    for rank, (dy, dx) in enumerate(offs.tolist()):
        y0, x0 = search + dy, search + dx
        sad = sad_per_mb(cur_i, ref_pad[..., y0:y0 + h, x0:x0 + w])
        take = sad < best_sad                        # strict: earlier wins
        best_sad = torch.where(take, sad, best_sad)
        best_idx = torch.where(take, rank, best_idx)
    mv = torch.from_numpy(offs).to(cur.device)[best_idx]
    return (mv,) + mc_predict(ref, ref_cb, ref_cr, mv)

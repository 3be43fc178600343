"""Device-side H.264 stripe encode step (counterpart of
``selkies_tpu/encoder/h264_device.py``).

* IDR stripes: Intra16x16 DC prediction with every MB its own slice, so
  the prediction is the constant 128 (all neighbours unavailable, §8.3.3).
* P stripes: inter only (P_16x16, one integer-pel MV per MB from the
  exhaustive search of ``ops/me_mc.py``).
* The reconstruction (dequant, inverse transform, clip) runs here with the
  decoder's exact arithmetic (``ops/h264_transform.py``), so the reference
  planes equal a conforming decoder's output bit for bit.

Each stripe is an independent video sequence (one client decoder per
stripe). The JAX package vmaps one stripe's function over the stripes;
here the stripe axis S is written out as the first axis of every tensor,
with one QP per stripe where paint-over raises it.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import h264_transform as ht
from ..ops.color import rgb_to_ycbcr_fused, subsample_420
from ..ops.me_mc import me_mc_stripes
from ..ops.motion import mc_predict, sad_per_mb
from . import device_cavlc as dcav

MB = 16
SEARCH = 12
#: frames per packer call in the batched programs: the packer's working
#: set (its slot grids) grows with the stripes it codes at once, so a
#: batch packs in chunks of this many frames (the served batch of 4 in
#: one call, bench.py's 12 in three) and keeps only each chunk's heads
PACK_FRAMES = 4


class StripeEncodeOut(NamedTuple):
    """Device outputs for S stripes of n MBs each (raster order). Luma 4x4
    blocks are indexed row-major within the MB; the coder reorders them to
    the spec's scan."""
    mv: torch.Tensor            # (S, n, 2) int32 (dy, dx); zeros for IDR
    luma: torch.Tensor          # (S, n, 16, 4, 4) int32 levels
    luma_dc: torch.Tensor       # (S, n, 4, 4) int32 (IDR only; zeros for P)
    chroma_dc: torch.Tensor     # (S, n, 2, 2, 2) int32
    chroma_ac: torch.Tensor     # (S, n, 2, 4, 4, 4) int32 (position 0 zeroed)
    recon_y: torch.Tensor       # (S, h, w) uint8
    recon_cb: torch.Tensor      # (S, h/2, w/2) uint8
    recon_cr: torch.Tensor      # (S, h/2, w/2) uint8


def _mb_blocks(plane: torch.Tensor, mb: int = MB) -> torch.Tensor:
    """(..., H, W) -> (..., n_mb, (mb/4)^2, 4, 4): raster MBs, raster 4x4s."""
    *lead, h, w = plane.shape
    nby, nbx = h // mb, w // mb
    g = mb // 4
    v = plane.reshape(*lead, nby, mb, nbx, mb).transpose(-3, -2)
    v = v.reshape(*lead, nby * nbx, g, 4, g, 4).transpose(-3, -2)
    return v.reshape(*lead, nby * nbx, g * g, 4, 4)


def _mb_unblocks(blocks: torch.Tensor, h: int, w: int, mb: int = MB
                 ) -> torch.Tensor:
    """Inverse of :func:`_mb_blocks`."""
    lead = blocks.shape[:-4]
    nby, nbx = h // mb, w // mb
    g = mb // 4
    v = blocks.reshape(*lead, nby * nbx, g, g, 4, 4).transpose(-3, -2)
    v = v.reshape(*lead, nby, nbx, mb, mb).transpose(-3, -2)
    return v.reshape(*lead, h, w)


#: x264-style decimation weights per 4x4 position: the cost of a lone
#: |level| == 1 there (high frequencies are expensive)
_DECIMATE_W = np.array([[0, 0, 0, 0],
                        [0, 0, 0, 1],
                        [0, 0, 1, 2],
                        [0, 1, 2, 3]], np.int32)


def _decimate_score(z: torch.Tensor) -> torch.Tensor:
    """Per-block x264-style decimation score; (..., 4, 4) -> (...)."""
    a = z.abs()
    w = ht.const(_DECIMATE_W, z.device)
    per = torch.where(a > 1, 9, torch.where(a == 1, w, 0))
    return per.sum((-2, -1), dtype=torch.int32)


def _set_dc(d: torch.Tensor, dc: torch.Tensor) -> torch.Tensor:
    """d with position (0, 0) of every 4x4 block replaced by dc (d[..., 0, 0]
    shaped)."""
    d = d.clone()
    d[..., 0, 0] = dc
    return d


def _encode_luma_residual(res_blocks, qp, intra, decimate: bool = False):
    """4x4 transform + quant and the decoder-side reconstruction.

    res_blocks (S, n, 16, 4, 4) int32 -> (levels, recon_res), both that
    shape. ``decimate`` (inter only) drops an MB's whole luma residual when
    its decimation score is < 6; the zeroed levels feed the reconstruction,
    so the reference stays decoder-exact."""
    w = ht.forward_dct4(res_blocks)
    z = ht.quant4(w, qp, intra=intra)
    if decimate and not intra:
        keep = _decimate_score(z).sum(-1) >= 6             # (S, n)
        z = torch.where(keep[..., None, None, None], z, 0)
    r = ht.inverse_dct4(ht.dequant4(z, qp))
    return z, r


def _encode_luma_i16(res_blocks, qp):
    """Intra16x16 luma: Hadamard DC + AC-only 4x4 levels.

    res_blocks (S, n, 16, 4, 4) -> (z_dc (S, n, 4, 4), z_ac, recon_res)."""
    w = ht.forward_dct4(res_blocks)
    dc = w[..., 0, 0].reshape(*w.shape[:-3], 4, 4)     # raster DC grid
    z_dc = ht.quant_dc16(ht.hadamard4_fwd(dc), qp)
    d_dc = ht.dequant_dc16(z_dc, qp)
    z_ac = _set_dc(ht.quant4(w, qp, intra=True), 0)
    d = _set_dc(ht.dequant4(z_ac, qp), d_dc.reshape(*w.shape[:-3], 16))
    return z_dc, z_ac, ht.inverse_dct4(d)


def _encode_chroma(res_blocks, qpc, intra, decimate: bool = False):
    """One chroma component: 2x2 Hadamard DC + AC blocks.

    res_blocks (S, n, 4, 4, 4) -> (z_dc (S, n, 2, 2), z_ac (S, n, 4, 4, 4),
    recon_res). ``decimate`` drops the AC levels when their per-MB score
    is <= 3; DC always survives."""
    w = ht.forward_dct4(res_blocks)
    dc = w[..., 0, 0].reshape(*w.shape[:-3], 2, 2)
    z_dc = ht.quant_dc2(ht.hadamard2_fwd(dc), qpc)
    d_dc = ht.dequant_dc2(z_dc, qpc)
    z_ac = _set_dc(ht.quant4(w, qpc, intra=intra), 0)
    if decimate and not intra:
        keep = _decimate_score(z_ac).sum(-1) > 3
        z_ac = torch.where(keep[..., None, None, None], z_ac, 0)
    d = _set_dc(ht.dequant4(z_ac, qpc), d_dc.reshape(*w.shape[:-3], 4))
    return z_dc, z_ac, ht.inverse_dct4(d)


def _clip8(x: torch.Tensor) -> torch.Tensor:
    return x.clamp(0, 255).to(torch.uint8)


def encode_stripe_idr(y, cb, cr, qp: int) -> StripeEncodeOut:
    """IDR stripes (S, h, w): I16x16/DC with per-MB slices (pred == 128)."""
    qpc = ht.qpc_for(qp)
    S, h, w = y.shape
    n = (h // MB) * (w // MB)
    z_dc, z_ac, r = _encode_luma_i16(_mb_blocks(y.to(torch.int32) - 128), qp)
    recon_y = _clip8(_mb_unblocks(r + 128, h, w))
    outs, recons = [], []
    for plane in (cb, cr):
        res = _mb_blocks(plane.to(torch.int32) - 128, mb=MB // 2)
        zc_dc, zc_ac, rc = _encode_chroma(res, qpc, intra=True)
        outs.append((zc_dc, zc_ac))
        recons.append(_clip8(_mb_unblocks(rc + 128, h // 2, w // 2,
                                          mb=MB // 2)))
    return StripeEncodeOut(
        mv=torch.zeros((S, n, 2), dtype=torch.int32, device=y.device),
        luma=z_ac, luma_dc=z_dc,
        chroma_dc=torch.stack([outs[0][0], outs[1][0]], dim=2),
        chroma_ac=torch.stack([outs[0][1], outs[1][1]], dim=2),
        recon_y=recon_y, recon_cb=recons[0], recon_cr=recons[1])


def encode_stripe_p_pred(y, cb, cr, mv_grid, pred_y, pred_cb, pred_cr,
                         qps: torch.Tensor) -> StripeEncodeOut:
    """P stripes (S, h, w) given the motion search's winners; ``qps`` is
    the [S] int32 QP per stripe."""
    qpc = ht.qpc_for(qps)
    S, h, w = y.shape
    res_y = _mb_blocks(y.to(torch.int32) - pred_y.to(torch.int32))
    z_l, r = _encode_luma_residual(res_y, qps, intra=False, decimate=True)
    recon_y = _clip8(_mb_unblocks(r, h, w) + pred_y.to(torch.int32))
    outs, recons = [], []
    for plane, pred in ((cb, pred_cb), (cr, pred_cr)):
        res = _mb_blocks(plane.to(torch.int32) - pred.to(torch.int32),
                         mb=MB // 2)
        zc_dc, zc_ac, rc = _encode_chroma(res, qpc, intra=False,
                                          decimate=True)
        outs.append((zc_dc, zc_ac))
        recons.append(_clip8(_mb_unblocks(rc, h // 2, w // 2, mb=MB // 2)
                             + pred.to(torch.int32)))
    n = (h // MB) * (w // MB)
    return StripeEncodeOut(
        mv=mv_grid.reshape(S, n, 2).to(torch.int32),
        luma=z_l,
        luma_dc=torch.zeros((S, n, 4, 4), dtype=torch.int32, device=y.device),
        chroma_dc=torch.stack([outs[0][0], outs[1][0]], dim=2),
        chroma_ac=torch.stack([outs[0][1], outs[1][1]], dim=2),
        recon_y=recon_y, recon_cb=recons[0], recon_cr=recons[1])


def _stripe_view(plane: torch.Tensor, n_stripes: int, sh: int):
    return plane.reshape(n_stripes, sh, plane.shape[-1])


def _first_argmax(x: torch.Tensor) -> torch.Tensor:
    """Index of the first maximum along the last axis (the lowest index
    among equal maxima), stated outright rather than left to argmax."""
    idx = torch.arange(x.shape[-1], device=x.device).expand_as(x)
    top = x.amax(-1, keepdim=True)
    return torch.where(x == top, idx, x.shape[-1]).amin(-1)


def _collapse_mv_ties(cur, ref, ref_cb, ref_cr, mv, pred_y, pred_cb,
                      pred_cr, *, search: int):
    """Re-point SAD-tied macroblocks at each stripe's dominant motion.

    The search breaks SAD ties toward small |mv| per MB in isolation, which
    checkerboards flat regions between mv=0 and the true motion. Every MB
    whose SAD at the stripe's most common winner EQUALS its own winner's
    SAD (a true tie: quality is untouched) moves onto it, so skip runs and
    MV prediction can form.

    cur/ref (S, h, w) u8; ref_cb/ref_cr (S, h/2, w/2) u8; mv (S, nby, nbx,
    2)."""
    S = cur.shape[0]
    nby, nbx = mv.shape[1:3]
    n = 2 * search + 1
    ridx = ((mv[..., 0] + search) * n + (mv[..., 1] + search)).reshape(S, -1)
    counts = torch.zeros((S, n * n), dtype=torch.int32, device=mv.device)
    counts.scatter_add_(1, ridx.long(), torch.ones_like(ridx,
                                                        dtype=torch.int32))
    dom = _first_argmax(counts)                          # first max wins
    ddy = dom // n - search
    ddx = dom % n - search
    mv_dom = torch.stack([ddy, ddx], -1).to(torch.int32)[:, None, None, :] \
        .expand(S, nby, nbx, 2)
    ref_dom, cb_dom, cr_dom = mc_predict(ref, ref_cb, ref_cr, mv_dom)
    take = sad_per_mb(cur, ref_dom) <= sad_per_mb(cur, pred_y)
    mv_new = torch.where(take[..., None], mv_dom, mv.to(torch.int32))
    take_px = take.repeat_interleave(MB, 1).repeat_interleave(MB, 2)
    take_cx = take.repeat_interleave(MB // 2, 1) \
        .repeat_interleave(MB // 2, 2)
    return (mv_new, torch.where(take_px, ref_dom, pred_y),
            torch.where(take_cx, cb_dom, pred_cb),
            torch.where(take_cx, cr_dom, pred_cr))


def _damage(y, cb, cr, prev_y, prev_cb, prev_cr, n_stripes: int):
    """[..., S] bool: stripes whose planes differ from the previous
    frame's (any leading axes: one frame or a batch)."""
    lead = y.shape[:-2]

    def differs(a, b):
        return (a != b).reshape(*lead, n_stripes, -1).any(-1)

    return (differs(y, prev_y) | differs(cb, prev_cb)
            | differs(cr, prev_cr))


def _frame_p_core(y, cb, cr, prev_y, prev_cb, prev_cr, ref_y, ref_cb,
                  ref_cr, paint, qp: int, paint_qp: int, *, n_stripes: int,
                  sh: int, search: int):
    """Whole-frame P encode, every stripe at once: damage, the motion
    search (one kernel launch for all stripes), tie collapse, transform /
    quant / recon; undamaged stripes keep their reference planes."""
    damage = _damage(y, cb, cr, prev_y, prev_cb, prev_cr, n_stripes)
    update = damage | (paint != 0)
    qps = torch.where(paint != 0, paint_qp, qp).to(torch.int32)
    enc, new_ref_y, new_ref_cb, new_ref_cr = _p_step(
        y, cb, cr, ref_y, ref_cb, ref_cr, update, qps, n_stripes=n_stripes,
        sh=sh, search=search)
    return enc, damage, update, new_ref_y, new_ref_cb, new_ref_cr


def _p_step(y, cb, cr, ref_y, ref_cb, ref_cr, update, qps, *,
            n_stripes: int, sh: int, search: int):
    """The reference chain of one P frame, given its stripes' update flags
    and QPs: the motion search (one kernel launch for all stripes), tie
    collapse, transform / quant / recon. Returns (enc, new reference
    planes); stripes without an update keep theirs."""
    S = n_stripes
    ys, cbs, crs = (_stripe_view(p, S, h) for p, h in
                    ((y, sh), (cb, sh // 2), (cr, sh // 2)))
    rys, rcbs, rcrs = (_stripe_view(p, S, h) for p, h in
                       ((ref_y, sh), (ref_cb, sh // 2), (ref_cr, sh // 2)))
    mv, pred_y, pred_cb, pred_cr = me_mc_stripes(ys, rys, rcbs, rcrs,
                                                 search=search)
    mv, pred_y, pred_cb, pred_cr = _collapse_mv_ties(
        ys, rys, rcbs, rcrs, mv, pred_y, pred_cb, pred_cr, search=search)
    enc = encode_stripe_p_pred(ys, cbs, crs, mv, pred_y, pred_cb, pred_cr,
                               qps)
    sel = update[:, None, None]
    new_ref_y = torch.where(sel, enc.recon_y, rys).reshape(y.shape)
    new_ref_cb = torch.where(sel, enc.recon_cb, rcbs).reshape(cb.shape)
    new_ref_cr = torch.where(sel, enc.recon_cr, rcrs).reshape(cr.shape)
    return enc, new_ref_y, new_ref_cb, new_ref_cr


def _pack_levels(enc: StripeEncodeOut) -> torch.Tensor:
    """flat16 [S, words] int16: the exact concat of (mv, luma, luma_dc,
    chroma_dc, chroma_ac) per stripe, the host coder's input. (The JAX
    package also derives a dense int8 copy, which the port does not use:
    its host tier ships the block-sparse pack, :func:`_pack_sparse`.)"""
    S = enc.mv.shape[0]
    parts = [enc.mv, enc.luma, enc.luma_dc, enc.chroma_dc, enc.chroma_ac]
    return torch.cat([p.reshape(S, -1) for p in parts], dim=1) \
        .to(torch.int16)


def prepare_planes(rgb: torch.Tensor, pad_h: int, pad_w: int):
    """RGB (..., H, W, 3) uint8 -> padded uint8 (Y, Cb, Cr) planes (one
    frame, or a batch on a leading axis); the pad replicates the edge (the
    SPS cropping hides it). The color transform is the fused form the JAX
    encoder's compiled step computes (see ``rgb_to_ycbcr_fused``), since
    rounding to integers exposes its last bit; it is elementwise, so a
    batch gives each frame's planes exactly."""
    h, w = rgb.shape[-3:-1]
    if (pad_h, pad_w) != (h, w):
        rows = torch.arange(pad_h, device=rgb.device).clamp(max=h - 1)
        cols = torch.arange(pad_w, device=rgb.device).clamp(max=w - 1)
        rgb = rgb.index_select(-3, rows).index_select(-2, cols)
    yf, cbf, crf = rgb_to_ycbcr_fused(rgb)
    y = _clip8(torch.round(yf).to(torch.int32))
    cb = _clip8(torch.round(subsample_420(cbf)).to(torch.int32))
    cr = _clip8(torch.round(subsample_420(crf)).to(torch.int32))
    return y, cb, cr


def encode_frame_idr_rgb(rgb, qp: int, *, pad_h: int, pad_w: int,
                         n_stripes: int, sh: int):
    """Whole-frame IDR: every stripe refreshes. Returns (flat16, y, cb, cr,
    ref_y, ref_cb, ref_cr); the new prev planes are y, cb, cr."""
    y, cb, cr = prepare_planes(rgb, pad_h, pad_w)
    S = n_stripes
    enc = encode_stripe_idr(_stripe_view(y, S, sh),
                            _stripe_view(cb, S, sh // 2),
                            _stripe_view(cr, S, sh // 2), qp)
    return (_pack_levels(enc), y, cb, cr, enc.recon_y.reshape(y.shape),
            enc.recon_cb.reshape(cb.shape), enc.recon_cr.reshape(cr.shape))


def encode_frame_p_cavlc_rgb(rgb, prev_y, prev_cb, prev_cr, ref_y, ref_cb,
                             ref_cr, paint, qp: int, paint_qp: int, *,
                             pad_h: int, pad_w: int, n_stripes: int, sh: int,
                             search: int = SEARCH, max_stripe_bytes: int,
                             prefix: int):
    """P frame with on-device CAVLC: planes, damage, motion search,
    transform / quant / recon and the entropy pack in one step. Returns
    (buf, head, flat16, y, cb, cr, ref_y, ref_cb, ref_cr): ``buf`` is the
    device-CAVLC buffer (``device_cavlc.pack_p_frame``), ``head`` its first
    ``prefix`` bytes (the fetch), ``flat16`` the exact levels kept on the
    device for overflowed stripes."""
    y, cb, cr = prepare_planes(rgb, pad_h, pad_w)
    enc, damage, update, nry, nrcb, nrcr = _frame_p_core(
        y, cb, cr, prev_y, prev_cb, prev_cr, ref_y, ref_cb, ref_cr,
        paint, qp, paint_qp, n_stripes=n_stripes, sh=sh, search=search)
    buf = dcav.pack_p_frame(
        enc.mv, enc.luma, enc.chroma_dc, enc.chroma_ac, damage, update,
        mb_w=pad_w // MB, mb_h=sh // MB, max_stripe_bytes=max_stripe_bytes)
    return (buf, buf[:prefix], _pack_levels(enc), y, cb, cr, nry, nrcb, nrcr)


#: sparse pack geometry: levels are grouped into 16-element cells; a
#: per-cell nonzero bitmap + the compacted nonzero cells are the transfer
CELL = 16
_BIT_WEIGHTS = np.array([1 << k for k in range(8)], np.int32)


def sparse_geometry(stripe_words: int,
                    cap_frac: int = 4) -> "tuple[int, int, int]":
    """(padded_words, n_cells, cap_cells) for one stripe's flat16 row."""
    pad_words = -(-stripe_words // (CELL * 8)) * (CELL * 8)
    n_cells = pad_words // CELL
    cap = max(1, n_cells // cap_frac)
    return pad_words, n_cells, cap


def _pack_sparse(flat16: torch.Tensor, damage: torch.Tensor,
                 update: torch.Tensor, cap_frac: int = 4,
                 frames: Optional[int] = None) -> torch.Tensor:
    """Block-sparse pack of the level buffer (P frames, host entropy).

    Most 16-element cells of the levels are all-zero at streaming QPs, so
    the fetch is a per-cell bitmap plus only the nonzero cells, compacted
    back to back across stripes, and the host reads a prefix sized by the
    content. The uint8 buffer:

      head   [S, 4]  — count_lo, count_hi, damage, overflow
      bitmap [S, n_cells/8] — LSB-first cell-nonzero bits
      cells  [S*cap*CELL] — int8 cell values, stripes back to back in
             bitmap order, zero after the last used cell

    The head keeps the count's low 16 bits only (a full-frame 1080p stripe
    has 209,104 cells, so the count can wrap); a stripe with more nonzero
    cells than ``cap`` or a |level| > 127 sets its overflow flag, and the
    host re-reads that stripe's exact flat16 row.

    ``frames=B`` packs B frames' stripes at once (rows frame-major) and
    returns [B, L]: each frame's cells compact on their own, so row b is
    the buffer frame b alone would give.
    """
    S, W = flat16.shape
    dev = flat16.device
    pad_words, n_cells, cap = sparse_geometry(W, cap_frac)
    blk = F.pad(flat16, (0, pad_words - W)).reshape(S, n_cells, CELL)
    nzb = (blk != 0).any(-1) & update.to(torch.bool)[:, None]     # [S, B]
    count = nzb.sum(1, dtype=torch.int64)                          # [S]
    # nonzero cells first, each group in its original order: a stable
    # sort of an integer key (0 = nonzero), not of the bool tensor
    order = torch.sort((~nzb).to(torch.uint8), dim=1,
                       stable=True).indices[:, :cap]
    cells16 = torch.gather(blk, 1, order[:, :, None].expand(S, cap, CELL))
    range_ovf = (cells16.to(torch.int32).abs() > 127).flatten(1).any(1)
    ovf = range_ovf | (count > cap)
    cells8 = cells16.clamp(-127, 127).to(torch.int8)

    bitmap = (nzb.reshape(S, n_cells // 8, 8).to(torch.int32)
              * ht.const(_BIT_WEIGHTS, dev)).sum(-1).to(torch.uint8)

    # compact each frame's used cells back to back across its stripes
    B = frames or 1
    fs = S // B
    used = (torch.clamp(count, max=cap) * CELL).reshape(B, fs)     # bytes
    starts = F.pad(torch.cumsum(used, 1)[:, :-1], (1, 0))
    total_cap = fs * cap * CELL
    j = torch.arange(total_cap, dtype=torch.int64, device=dev) \
        .repeat(B, 1)
    sidx = (torch.searchsorted(starts, j, right=True) - 1).clamp(0, fs - 1)
    within = j - starts.gather(1, sidx)
    valid = within < used.gather(1, sidx)
    gathered = cells8.reshape(B, total_cap).gather(
        1, sidx * (cap * CELL) + within.clamp(0, cap * CELL - 1))
    cells_out = torch.where(valid, gathered, torch.zeros_like(gathered))

    head = torch.stack([count & 0xFF, (count >> 8) & 0xFF,
                        damage.to(torch.int64), ovf.to(torch.int64)],
                       dim=1).to(torch.uint8)                      # [S, 4]
    buf = torch.cat([head.reshape(B, -1), bitmap.reshape(B, -1),
                     cells_out.view(torch.uint8)], dim=1)
    return buf if frames else buf[0]


def encode_frame_p_rgb(rgb, prev_y, prev_cb, prev_cr, ref_y, ref_cb, ref_cr,
                       paint, qp: int, paint_qp: int, *, pad_h: int,
                       pad_w: int, n_stripes: int, sh: int,
                       search: int = SEARCH, cap_frac: int = 4,
                       prefix: int):
    """P frame for host entropy: planes, damage, motion search, transform
    / quant / recon and the block-sparse pack of the levels in one step.
    Returns (buf, head, flat16, y, cb, cr, ref_y, ref_cb, ref_cr): ``buf``
    is the :func:`_pack_sparse` buffer, ``head`` its first ``prefix`` bytes
    (the fetch), ``flat16`` the exact levels kept on the device for
    overflowed stripes."""
    y, cb, cr = prepare_planes(rgb, pad_h, pad_w)
    enc, damage, update, nry, nrcb, nrcr = _frame_p_core(
        y, cb, cr, prev_y, prev_cb, prev_cr, ref_y, ref_cb, ref_cr,
        paint, qp, paint_qp, n_stripes=n_stripes, sh=sh, search=search)
    flat16 = _pack_levels(enc)
    buf = _pack_sparse(flat16, damage, update, cap_frac=cap_frac)
    return (buf, buf[:prefix], flat16, y, cb, cr, nry, nrcb, nrcr)


def _encode_p_batch(rgbs, prev_y, prev_cb, prev_cr, ref_y, ref_cb, ref_cr,
                    paints, qps, paint_qp: int, *, pad_h: int, pad_w: int,
                    n_stripes: int, sh: int, search: int):
    """What both batched P programs share. The planes, damage, update
    flags and QPs of the B frames are computed at once (elementwise, so
    each frame's are exact: frame b's damage is against frame b-1's
    planes, frame 0's against ``prev``); the reference chain then runs
    frame by frame, one motion-search launch each, since frame b
    predicts from frame b-1's reconstruction. Returns (encs, damage [B, S],
    update [B, S], flat16s [B, S, words], last planes, new references)."""
    y, cb, cr = prepare_planes(rgbs, pad_h, pad_w)                # [B, ...]
    damage = _damage(y, cb, cr, torch.cat([prev_y[None], y[:-1]]),
                     torch.cat([prev_cb[None], cb[:-1]]),
                     torch.cat([prev_cr[None], cr[:-1]]), n_stripes)
    paints = paints != 0
    update = damage | paints
    qp_s = torch.where(paints, paint_qp, qps[:, None]).to(torch.int32)
    encs, flat16s = [], []
    for b in range(y.shape[0]):
        enc, ref_y, ref_cb, ref_cr = _p_step(
            y[b], cb[b], cr[b], ref_y, ref_cb, ref_cr, update[b], qp_s[b],
            n_stripes=n_stripes, sh=sh, search=search)
        encs.append(enc)
        flat16s.append(_pack_levels(enc))
    return (encs, damage, update, torch.stack(flat16s), y[-1], cb[-1],
            cr[-1], ref_y, ref_cb, ref_cr)


def encode_frame_p_batch_cavlc_rgb(rgbs, prev_y, prev_cb, prev_cr, ref_y,
                                   ref_cb, ref_cr, paints, qps,
                                   paint_qp: int, *, pad_h: int, pad_w: int,
                                   n_stripes: int, sh: int,
                                   search: int = SEARCH,
                                   max_stripe_bytes: int, prefix: int):
    """B sequential P frames with on-device CAVLC (the JAX package's
    ``lax.scan`` over :func:`encode_frame_p_cavlc_rgb`).

    rgbs (B, H, W, 3) uint8; paints (B, S) int32; qps (B,) int32.
    Returns (heads [B, prefix], flat16s [B, S, words], the last frame's
    y, cb, cr, and the new reference planes). The packer runs once over
    the stripes of every ``PACK_FRAMES`` frames (each stripe is coded on
    its own), each frame's stripes compacting on their own, so head b
    equals frame b's single-frame buffer's first ``prefix`` bytes."""
    (encs, damage, update, flat16s, y, cb, cr, nry, nrcb,
     nrcr) = _encode_p_batch(
        rgbs, prev_y, prev_cb, prev_cr, ref_y, ref_cb, ref_cr, paints, qps,
        paint_qp, pad_h=pad_h, pad_w=pad_w, n_stripes=n_stripes, sh=sh,
        search=search)

    def pack(lo, hi):
        return dcav.pack_p_frame(
            *(torch.cat([getattr(e, k) for e in encs[lo:hi]])
              for k in ("mv", "luma", "chroma_dc", "chroma_ac")),
            damage[lo:hi].reshape(-1), update[lo:hi].reshape(-1),
            mb_w=pad_w // MB, mb_h=sh // MB,
            max_stripe_bytes=max_stripe_bytes, frames=hi - lo)

    return (_chunked_heads(pack, len(encs), prefix), flat16s, y, cb, cr,
            nry, nrcb, nrcr)


def encode_frame_p_batch_rgb(rgbs, prev_y, prev_cb, prev_cr, ref_y, ref_cb,
                             ref_cr, paints, qps, paint_qp: int, *,
                             pad_h: int, pad_w: int, n_stripes: int, sh: int,
                             search: int = SEARCH, cap_frac: int = 4,
                             prefix: int):
    """B sequential P frames for host entropy (the JAX package's
    ``lax.scan`` over :func:`encode_frame_p_rgb`); arguments and returns
    as :func:`encode_frame_p_batch_cavlc_rgb`. The sparse pack runs once
    over the stripes of every ``PACK_FRAMES`` frames, with each frame's
    cells compacted on their own (``_pack_sparse(frames=n)``), so head b
    equals frame b's single-frame buffer's first ``prefix`` bytes."""
    (_, damage, update, flat16s, y, cb, cr, nry, nrcb,
     nrcr) = _encode_p_batch(
        rgbs, prev_y, prev_cb, prev_cr, ref_y, ref_cb, ref_cr, paints, qps,
        paint_qp, pad_h=pad_h, pad_w=pad_w, n_stripes=n_stripes, sh=sh,
        search=search)

    def pack(lo, hi):
        return _pack_sparse(flat16s[lo:hi].reshape((hi - lo) * n_stripes, -1),
                            damage[lo:hi].reshape(-1),
                            update[lo:hi].reshape(-1), cap_frac=cap_frac,
                            frames=hi - lo)

    return (_chunked_heads(pack, flat16s.shape[0], prefix), flat16s, y, cb,
            cr, nry, nrcb, nrcr)


def _merge_idr(enc_p: StripeEncodeOut, enc_i: StripeEncodeOut,
               idr: torch.Tensor) -> StripeEncodeOut:
    """Per-stripe select between the inter and intra encodes. ``idr`` [S]
    bool; every field carries the stripe axis first."""
    def sel(a, b):
        return torch.where(idr.reshape((-1,) + (1,) * (a.dim() - 1)), a, b)

    return StripeEncodeOut(*[sel(a, b) for a, b in zip(enc_i, enc_p)])


def encode_frame_p_sessions_rgb(rgbs, prev_y, prev_cb, prev_cr, ref_y,
                                ref_cb, ref_cr, paint, idr, qp: int,
                                paint_qp: int, *, pad_h: int, pad_w: int,
                                n_stripes: int, sh: int,
                                search: int = SEARCH, with_idr: bool,
                                entropy: str, cap_frac: int = 4,
                                max_stripe_bytes: int = 0, prefix: int):
    """One frame of each of N independent sessions in one step (the JAX
    lane ``vmap``s the striped P step over its sessions).

    rgbs [N, pad_h, pad_w, 3] uint8; the plane state [N, ...]; paint and
    idr [N, S] int32. Every stripe is its own sequence with its own
    reference window, so the sessions fold into the stripe axis: damage,
    one motion-search launch over all N*S stripes, tie collapse,
    transform, quant and reconstruction run once over them. ``with_idr``
    also codes every stripe as Intra16x16 and keeps it where ``idr`` is
    set (the JAX lane's mixed program). The packer runs per
    ``PACK_FRAMES`` sessions' stripes, each session compacting on its
    own: ``entropy="device"`` packs CAVLC P slices (IDR stripes masked
    out: they recover from their exact levels on the host),
    ``"sparse"`` the block-sparse levels. Returns (heads [N, prefix],
    flat16 [N, S, words], y, cb, cr, ref_y, ref_cb, ref_cr [N, ...]); row
    n of the heads is session n's one-session buffer, byte for byte."""
    N = rgbs.shape[0]
    S = n_stripes
    NS = N * S
    y, cb, cr = prepare_planes(rgbs, pad_h, pad_w)            # [N, ...]

    def fold(t):
        return t.reshape(-1, t.shape[-1])

    paint = paint.reshape(-1)
    enc, damage, update, nry, nrcb, nrcr = _frame_p_core(
        fold(y), fold(cb), fold(cr), fold(prev_y), fold(prev_cb),
        fold(prev_cr), fold(ref_y), fold(ref_cb), fold(ref_cr), paint, qp,
        paint_qp, n_stripes=NS, sh=sh, search=search)
    upd_p = update
    if with_idr:
        idr_f = idr.reshape(-1) != 0
        ys, cbs, crs = (_stripe_view(fold(p), NS, h) for p, h in
                        ((y, sh), (cb, sh // 2), (cr, sh // 2)))
        enc_i = encode_stripe_idr(ys, cbs, crs, qp)
        enc = _merge_idr(enc, enc_i, idr_f)
        damage = damage | idr_f
        update = update | idr_f
        upd_p = update & ~idr_f
        sel = idr_f[:, None, None]
        nry = torch.where(sel, enc_i.recon_y, _stripe_view(nry, NS, sh))
        nrcb = torch.where(sel, enc_i.recon_cb,
                           _stripe_view(nrcb, NS, sh // 2))
        nrcr = torch.where(sel, enc_i.recon_cr,
                           _stripe_view(nrcr, NS, sh // 2))
    flat16 = _pack_levels(enc)                                 # [NS, words]
    if entropy == "device":
        def pack(lo, hi):
            rows = slice(lo * S, hi * S)
            return dcav.pack_p_frame(
                enc.mv[rows], enc.luma[rows], enc.chroma_dc[rows],
                enc.chroma_ac[rows], damage[rows], upd_p[rows],
                mb_w=pad_w // MB, mb_h=sh // MB,
                max_stripe_bytes=max_stripe_bytes, frames=hi - lo)
    else:
        def pack(lo, hi):
            rows = slice(lo * S, hi * S)
            return _pack_sparse(flat16[rows], damage[rows], update[rows],
                                cap_frac=cap_frac, frames=hi - lo)

    return (_chunked_heads(pack, N, prefix), flat16.reshape(N, S, -1),
            y, cb, cr, nry.reshape(prev_y.shape),
            nrcb.reshape(prev_cb.shape), nrcr.reshape(prev_cr.shape))


def _chunked_heads(pack, B: int, prefix: int) -> torch.Tensor:
    """[B, prefix] heads of B frames' buffers, packed ``PACK_FRAMES``
    frames per call by ``pack(lo, hi)`` ([hi - lo, L]; row b is frame b's
    one-frame buffer, so the chunking changes no byte)."""
    return torch.cat([pack(lo, min(B, lo + PACK_FRAMES))[:, :prefix]
                      for lo in range(0, B, PACK_FRAMES)])

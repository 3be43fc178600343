"""Stripe-batched motion search + compensation: the Hopper kernel and its
plain version.

Replaces ``selkies_tpu/ops/pallas_me.py:me_mc_stripes``. The kernel is
``csrc/me_mc.cu`` (CUDA C++ for sm_90a, built by nvcc at first use and
bound with ctypes): one launch searches and predicts. Its source says what
bounds it (byte-SIMD integer instructions: 1.31 G byte differences per
1080p frame) and how its design follows.

:func:`me_mc_stripes` is the wrapper the encoder calls. A CPU tensor goes
through the plain version, :func:`~.motion.full_search_mc`; a CUDA tensor
launches the kernel or raises — there is no fallback from one to the
other. Each launch runs with the planes' device current and adds one to
``me_mc_stripes.launches`` and to its device's entry of
``me_mc_stripes.launches_by_device``.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .h264_transform import const
from .motion import MB, _offsets, full_search_mc

_STEM = "me_mc"
#: the kernel's largest search radius (its rank key holds 10 bits)
MAX_SEARCH = 15


@functools.lru_cache(maxsize=None)
def _library():
    from .._build import load_library

    lib = load_library(_STEM)
    fn = lib.me_mc_launch
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                   + [ctypes.c_void_p] * 5)
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _offset_table(search: int):
    return _offsets(search)


@functools.lru_cache(maxsize=None)
def _rank_table(search: int) -> np.ndarray:
    """rank[dy + search, dx + search] = index of (dy, dx) in the sorted
    offset table: the kernel's key takes its low bits from it."""
    n = 2 * search + 1
    rank = np.zeros((n, n), np.int32)
    offs = _offset_table(search)
    rank[offs[:, 0] + search, offs[:, 1] + search] = np.arange(len(offs))
    return rank


def me_mc_stripes(cur: torch.Tensor, ref: torch.Tensor,
                  ref_cb: torch.Tensor, ref_cr: torch.Tensor, *,
                  search: int = 12):
    """cur/ref (S, h, w) u8 luma, ref_cb/ref_cr (S, h/2, w/2) u8 →
    (mv (S, h/16, w/16, 2) int32, pred_y (S, h, w), pred_cb, pred_cr
    (S, h/2, w/2) u8), the selection rule of ``full_search_mc``."""
    if cur.dim() != 3 or cur.shape != ref.shape:
        raise ValueError(f"cur/ref must be (S, h, w) alike, got "
                         f"{tuple(cur.shape)} and {tuple(ref.shape)}")
    S, h, w = cur.shape
    if h % MB or w % MB:
        raise ValueError(f"h, w must be multiples of {MB}, got {h}x{w}")
    for name, t in (("ref_cb", ref_cb), ("ref_cr", ref_cr)):
        if tuple(t.shape) != (S, h // 2, w // 2):
            raise ValueError(f"{name} must be {(S, h // 2, w // 2)}, "
                             f"got {tuple(t.shape)}")
    if not 0 <= search <= MAX_SEARCH:
        raise ValueError(f"search must be in [0, {MAX_SEARCH}], got {search}")
    if cur.device.type == "cpu":
        return full_search_mc(cur, ref, ref_cb, ref_cr, search=search)
    if cur.device.type != "cuda":
        raise ValueError(f"unsupported device {cur.device}")
    dev = cur.device
    for name, t in (("cur", cur), ("ref", ref), ("ref_cb", ref_cb),
                    ("ref_cr", ref_cr)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, cur on {dev}")
        if t.dtype != torch.uint8:
            raise TypeError(f"{name} must be uint8, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    major, minor = torch.cuda.get_device_capability(dev)
    if (major, minor) != (9, 0):
        raise RuntimeError(f"me_mc.cu is built for sm_90a; device {dev} "
                           f"is sm_{major}{minor}")
    fn = _library()
    ranks = const(_rank_table(search), dev)
    offs = const(_offset_table(search), dev)
    mv = torch.empty((S, h // MB, w // MB, 2), dtype=torch.int32, device=dev)
    pred_y = torch.empty_like(cur)
    pred_cb = torch.empty_like(ref_cb)
    pred_cr = torch.empty_like(ref_cr)
    # the launch goes to the current device's context: make the planes'
    # device current, whichever device the caller had current
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(cur.data_ptr(), ref.data_ptr(), ref_cb.data_ptr(),
                 ref_cr.data_ptr(), ranks.data_ptr(), offs.data_ptr(),
                 search, S, h, w, mv.data_ptr(), pred_y.data_ptr(),
                 pred_cb.data_ptr(), pred_cr.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"me_mc launch failed on {dev}: CUDA error {err}")
    me_mc_stripes.launches += 1
    by_dev = me_mc_stripes.launches_by_device
    by_dev[str(dev)] = by_dev.get(str(dev), 0) + 1
    return mv, pred_y, pred_cb, pred_cr


#: kernel launches since the last reset (plain-version calls do not
#: count), in total and by device ("cuda:0": n)
me_mc_stripes.launches = 0
me_mc_stripes.launches_by_device = {}

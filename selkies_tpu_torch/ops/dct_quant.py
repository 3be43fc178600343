"""Fused 8x8 DCT + quantize + zigzag: the Hopper kernel and its plain version.

Replaces ``selkies_tpu/ops/pallas_dct.py:dct8_quant_raster`` (with its
zigzag wrapper ``dct8_quant_zigzag``) plus the int16 cast of the JPEG step.
The kernel is ``csrc/dct_quant.cu`` (CUDA C++ for sm_90a, built by nvcc at
first use and bound with ctypes); its source says what bounds it (memory:
~19 MB per 1080p frame, ~6 us at 3.35 TB/s) and how its design follows.

:func:`dct8_quant_zigzag` is the wrapper the encoder calls, once per frame
with its Y, Cb and Cr planes. CPU tensors go through
:func:`dct8_quant_zigzag_plain`, plane by plane; CUDA tensors launch the
kernel once for all planes or raise — there is no fallback from one to the
other. Each launch runs with the planes' device current and adds one to
``dct8_quant_zigzag.launches`` and to its device's entry of
``dct8_quant_zigzag.launches_by_device``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Sequence, Tuple

import torch

from .dct import _dct8_np, block_dct2, blockify
from .quant import ZIGZAG

_STEM = "dct_quant"


def _zigzag_index(device) -> torch.Tensor:
    return torch.from_numpy(ZIGZAG).to(device=device, dtype=torch.long)


def dct8_quant_zigzag_plain(plane: torch.Tensor, recip: torch.Tensor,
                            row_idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version, in the JAX step's order of operations
    (selkies_tpu/encoder/jpeg.py:83-91): level shift, C·X·Cᵀ, multiply by
    the band's f32 reciprocal table, round half to even, int16, zigzag."""
    h, w = plane.shape
    by, bx = h // 8, w // 8
    blocks = blockify(plane) - 128.0                      # [by, bx, 8, 8]
    coeffs = block_dct2(blocks)
    row_recip = recip[row_idx.long().clamp(0, recip.shape[0] - 1)]
    q = torch.round(coeffs * row_recip[:, None]).to(torch.int16)
    return q.reshape(by, bx, 64).index_select(-1, _zigzag_index(q.device))


class _Plane(ctypes.Structure):
    """``struct Plane`` of csrc/dct_quant.cu."""

    _fields_ = [("plane", ctypes.c_void_p), ("recip", ctypes.c_void_p),
                ("row_idx", ctypes.c_void_p), ("out", ctypes.c_void_p),
                ("H", ctypes.c_int), ("W", ctypes.c_int),
                ("pitch", ctypes.c_int), ("nq", ctypes.c_int)]


#: planes one launch takes (Y, Cb, Cr)
MAX_PLANES = 3


@functools.lru_cache(maxsize=None)
def _library():
    from .._build import load_library

    lib = load_library(_STEM)
    fn = lib.dct8_quant_zigzag_launch
    fn.argtypes = [ctypes.POINTER(_Plane), ctypes.c_int,
                   ctypes.POINTER(ctypes.c_float), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _cmat_host():
    """The DCT matrix as the 64 host floats the launch copies into the
    kernel's arguments."""
    return (ctypes.c_float * 64)(*_dct8_np().ravel().tolist())


def _check_plane(plane, recip, row_idx) -> None:
    if plane.dim() != 2 or plane.shape[0] % 8 or plane.shape[1] % 8:
        raise ValueError(f"plane must be [H, W] with H, W % 8 == 0, "
                         f"got {tuple(plane.shape)}")
    h = plane.shape[0]
    if recip.dim() != 3 or tuple(recip.shape[1:]) != (8, 8):
        raise ValueError(f"recip must be [nq, 8, 8], got {tuple(recip.shape)}")
    if row_idx.shape != (h // 8,):
        raise ValueError(f"row_idx must be [{h // 8}], got {tuple(row_idx.shape)}")


def _check_cuda(plane, recip, row_idx, dev) -> None:
    for name, t, dt in (("plane", plane, torch.float32),
                        ("recip", recip, torch.float32),
                        ("row_idx", row_idx, torch.int32)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, the first plane on {dev}")
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if name != "plane" and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    # rows may be apart (a view), each row contiguous and 16-byte aligned
    if plane.stride(1) != 1 or plane.stride(0) % 4:
        raise ValueError(f"plane rows must be contiguous, 4-float aligned "
                         f"apart; got strides {plane.stride()}")
    if plane.data_ptr() % 16 or recip.data_ptr() % 16:
        raise ValueError("plane and recip must be 16-byte aligned")


def dct8_quant_zigzag(planes: Sequence[Tuple[torch.Tensor, torch.Tensor,
                                              torch.Tensor]]
                      ) -> List[torch.Tensor]:
    """One frame's planes, each ``(plane [H, W] f32, recip [nq, 8, 8] f32,
    row_idx [H/8] i32)``, → for each a [H/8, W/8, 64] int16 tensor of
    quantized coefficients in zigzag order.

    H and W must be multiples of 8 (any W: the 1080p chroma planes are
    544x960). On the card all planes (at most three) go through one kernel
    launch; a plane may be a view whose rows are apart (no copy needed)."""
    planes = list(planes)
    if not 1 <= len(planes) <= MAX_PLANES:
        raise ValueError(f"1 to {MAX_PLANES} planes per call, got {len(planes)}")
    for p in planes:
        _check_plane(*p)
    dev = planes[0][0].device
    if dev.type == "cpu":
        if any(t.device != dev for p in planes for t in p):
            raise ValueError("the planes and tables must share one device")
        return [dct8_quant_zigzag_plain(*p) for p in planes]
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    for p in planes:
        _check_cuda(*p, dev)
    major, minor = torch.cuda.get_device_capability(dev)
    if (major, minor) != (9, 0):
        raise RuntimeError(f"dct_quant.cu is built for sm_90a; device {dev} "
                           f"is sm_{major}{minor}")
    fn = _library()
    outs, args = [], (_Plane * len(planes))()
    for a, (plane, recip, row_idx) in zip(args, planes):
        h, w = plane.shape
        out = torch.empty((h // 8, w // 8, 64), dtype=torch.int16, device=dev)
        outs.append(out)
        a.plane, a.recip, a.row_idx, a.out = (
            plane.data_ptr(), recip.data_ptr(), row_idx.data_ptr(),
            out.data_ptr())
        a.H, a.W, a.pitch, a.nq = h, w, plane.stride(0), recip.shape[0]
    # the launch goes to the current device's context: make the planes'
    # device current, whichever device the caller had current
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(args, len(planes), _cmat_host(), stream)
    if err != 0:
        raise RuntimeError(f"dct8_quant_zigzag launch failed on {dev}: "
                           f"CUDA error {err}")
    dct8_quant_zigzag.launches += 1
    by_dev = dct8_quant_zigzag.launches_by_device
    by_dev[str(dev)] = by_dev.get(str(dev), 0) + 1
    return outs


#: kernel launches since the last reset (plain-version calls do not
#: count), in total and by device ("cuda:0": n)
dct8_quant_zigzag.launches = 0
dct8_quant_zigzag.launches_by_device = {}

"""Fused 8x8 DCT + quantize + zigzag: the Hopper kernel and its plain version.

Replaces ``selkies_tpu/ops/pallas_dct.py:dct8_quant_raster`` (with its
zigzag wrapper ``dct8_quant_zigzag``) plus the int16 cast of the JPEG step.
The kernel is ``csrc/dct_quant.cu`` (CUDA C++ for sm_90a, built by nvcc at
first use and bound with ctypes); its source says what bounds it (memory:
~19 MB per 1080p frame, ~6 us at 3.35 TB/s) and how its design follows.

:func:`dct8_quant_zigzag` is the wrapper the encoder calls. A CPU tensor
goes through :func:`dct8_quant_zigzag_plain`; a CUDA tensor launches the
kernel or raises — there is no fallback from one to the other. Each launch
adds one to ``dct8_quant_zigzag.launches``.
"""

from __future__ import annotations

import ctypes
import functools

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


@functools.lru_cache(maxsize=None)
def _library():
    from .._build import load_library

    lib = load_library(_STEM)
    fn = lib.dct8_quant_zigzag_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


_cmat_cache = {}


def _cmat(device: torch.device) -> torch.Tensor:
    c = _cmat_cache.get(device)
    if c is None:
        c = torch.from_numpy(_dct8_np()).to(device).contiguous()
        _cmat_cache[device] = c
    return c


def dct8_quant_zigzag(plane: torch.Tensor, recip: torch.Tensor,
                      row_idx: torch.Tensor) -> torch.Tensor:
    """plane [H, W] f32, recip [nq, 8, 8] f32, row_idx [H/8] i32
    → [H/8, W/8, 64] int16 quantized coefficients in zigzag order.

    H and W must be multiples of 8 (any W: the 1080p chroma planes are
    544x960)."""
    if plane.dim() != 2 or plane.shape[0] % 8 or plane.shape[1] % 8:
        raise ValueError(f"plane must be [H, W] with H, W % 8 == 0, "
                         f"got {tuple(plane.shape)}")
    h, w = plane.shape
    if recip.dim() != 3 or tuple(recip.shape[1:]) != (8, 8):
        raise ValueError(f"recip must be [nq, 8, 8], got {tuple(recip.shape)}")
    if row_idx.shape != (h // 8,):
        raise ValueError(f"row_idx must be [{h // 8}], got {tuple(row_idx.shape)}")
    if plane.device.type == "cpu":
        return dct8_quant_zigzag_plain(plane, recip, row_idx)
    if plane.device.type != "cuda":
        raise ValueError(f"unsupported device {plane.device}")
    dev = plane.device
    for name, t, dt in (("plane", plane, torch.float32),
                        ("recip", recip, torch.float32),
                        ("row_idx", row_idx, torch.int32)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, plane on {dev}")
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if plane.data_ptr() % 16:
        raise ValueError("plane must be 16-byte aligned (float4 loads)")
    major, minor = torch.cuda.get_device_capability(dev)
    if (major, minor) != (9, 0):
        raise RuntimeError(f"dct_quant.cu is built for sm_90a; device {dev} "
                           f"is sm_{major}{minor}")
    fn = _library()
    out = torch.empty((h // 8, w // 8, 64), dtype=torch.int16, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(plane.data_ptr(), recip.data_ptr(), row_idx.data_ptr(),
             _cmat(dev).data_ptr(), out.data_ptr(), h, w, recip.shape[0],
             stream)
    if err != 0:
        raise RuntimeError(f"dct8_quant_zigzag launch failed: CUDA error {err}")
    dct8_quant_zigzag.launches += 1
    return out


#: kernel launches since the last reset (plain-version calls do not count)
dct8_quant_zigzag.launches = 0

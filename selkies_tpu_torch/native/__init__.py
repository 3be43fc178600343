"""Host C++ components of the port, built with g++ at first use.

The port's own copies of the H.264 CAVLC slice coder (``cavlc.cpp``) and of
the JPEG 4:2:0 scan coder (``entropy.cpp``) are each compiled with
``g++ -O3 -shared -fPIC`` into the port's kernel directory
(``build/torch_kernels/``, see ``_build.kernel_dir``), named by a hash of
the source and flags, and loaded with ctypes. Nothing is built or loaded at
import time, and a failed build raises: the encoders never run on without
their coder (there is no quiet switch to a Python coder).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_DIR = Path(__file__).resolve().parent
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

#: the warm-up thread and a display's driver thread may both reach the
#: coder first; one builds, the other waits
_lock = threading.Lock()


def _build(stem: str) -> ctypes.CDLL:
    from .._build import kernel_dir

    src = _DIR / f"{stem}.cpp"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
    out_dir = kernel_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    so = out_dir / f"lib{stem}_host_{digest}.so"
    if not so.exists():
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(src)],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(
                f"g++ failed for {src.name}:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, so)
    return ctypes.CDLL(str(so))


_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_i16p = np.ctypeslib.ndpointer(np.int16, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")


@functools.lru_cache(maxsize=None)
def _cavlc_lib() -> ctypes.CDLL:
    lib = _build("cavlc")
    fn = lib.h264_encode_picture
    fn.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int,
        _i32p, _i32p, _i32p, _i32p, _i32p,
        _u8p, ctypes.c_int64, ctypes.c_int,
    ]
    fn.restype = ctypes.c_int64
    return lib


def cavlc_lib() -> ctypes.CDLL:
    """The compiled H.264 CAVLC slice coder (raises if it cannot be built)."""
    with _lock:
        return _cavlc_lib()


@functools.lru_cache(maxsize=None)
def _entropy_lib() -> ctypes.CDLL:
    lib = _build("entropy")
    fn = lib.jpeg_encode_scan_420
    fn.argtypes = [
        _i16p, _i16p, _i16p, ctypes.c_int, ctypes.c_int,
        _u32p, _u8p, _u32p, _u8p, _u32p, _u8p, _u32p, _u8p,
        _u8p, ctypes.c_int64,
    ]
    fn.restype = ctypes.c_int64
    return lib


def entropy_lib() -> ctypes.CDLL:
    """The compiled JPEG 4:2:0 scan coder (raises if it cannot be built)."""
    with _lock:
        return _entropy_lib()

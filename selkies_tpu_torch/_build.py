"""Build the port's CUDA sources into shared libraries at first use.

Route: ``nvcc`` compiles each ``csrc/*.cu`` into a shared library with a
plain C interface, loaded with ``ctypes`` (no PyTorch headers, so a build
takes seconds). Libraries land in ``build/torch_kernels/`` beside the
package (``SELKIES_TORCH_KERNEL_DIR`` overrides), named by a hash of the
source and flags, so an edited source is rebuilt and an unchanged one is
reused. Nothing here runs at import time: the CPU tests import every
module on hosts without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ("-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
#: nvcc's -Xptxas -v report per library (registers, shared memory, spills)
ptxas_report: Dict[str, str] = {}


def kernel_dir() -> Path:
    env = os.environ.get("SELKIES_TORCH_KERNEL_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parent.parent / "build" / "torch_kernels"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "from csrc/ with the CUDA toolkit at first use")


def load_library(stem: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<stem>.cu``; raises on failure."""
    with _lock:
        lib = _loaded.get(stem)
        if lib is not None:
            return lib
        src = CSRC / f"{stem}.cu"
        flags = ARCH_FLAGS + NVCC_FLAGS
        digest = hashlib.sha256(
            src.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
        out_dir = kernel_dir()
        out_dir.mkdir(parents=True, exist_ok=True)
        so = out_dir / f"lib{stem}_{digest}.so"
        if not so.exists():
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run(
                [_nvcc(), *flags, "-o", str(tmp), str(src)],
                capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed for {src.name}:\n{proc.stdout}{proc.stderr}")
            ptxas_report[stem] = (proc.stdout + proc.stderr).strip()
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        _loaded[stem] = lib
        return lib

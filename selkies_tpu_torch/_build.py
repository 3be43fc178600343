"""Build the port's CUDA sources into shared libraries at first use.

Route: ``nvcc`` compiles each ``csrc/*.cu`` into a shared library with a
plain C interface, loaded with ``ctypes`` (no PyTorch headers, so a build
takes seconds). Libraries land in ``build/torch_kernels/`` beside the
package (``SELKIES_TORCH_KERNEL_DIR`` overrides), named by a hash of the
source and flags, so an edited source is rebuilt and an unchanged one is
reused. Nothing here runs at import time: the CPU tests import every
module on hosts without ``nvcc``.

``python -m selkies_tpu_torch._build --sass FILE.cu ...`` builds each
given source with the same flags (into a temporary directory) and prints,
as one JSON object, the SASS opcodes (with their modifiers) of each of its
kernels with their counts, from ``cuobjdump -sass``: what ptxas made of
the source, for checking a kernel's instruction count against its bound.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
from collections import Counter
from pathlib import Path
from typing import Dict, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ("-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
#: nvcc's -Xptxas -v report per library (registers, shared memory, spills)
ptxas_report: Dict[str, str] = {}
#: the built library of each loaded source
libraries: Dict[str, Path] = {}


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


def _cuobjdump() -> Optional[str]:
    """cuobjdump: on PATH, beside nvcc, or Triton's copy."""
    found = shutil.which("cuobjdump")
    if found:
        return found
    try:
        cand = Path(_nvcc()).parent / "cuobjdump"
        if cand.exists():
            return str(cand)
    except RuntimeError:
        pass
    try:
        import triton
    except ImportError:
        return None
    cand = (Path(triton.__file__).parent / "backends" / "nvidia" / "bin"
            / "cuobjdump")
    return str(cand) if cand.exists() else None


def compile_source(src: Path, out: Path) -> str:
    """nvcc ``src`` into the shared library ``out``; returns ptxas's report
    (raises with nvcc's output on failure)."""
    proc = subprocess.run(
        [_nvcc(), *ARCH_FLAGS, *NVCC_FLAGS, "-o", str(out), str(src)],
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed for {src.name}:\n{proc.stdout}{proc.stderr}")
    return (proc.stdout + proc.stderr).strip()


_OPCODE = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)")


def sass_opcodes(library: Path) -> Dict[str, Dict[str, int]]:
    """Counts of each opcode, with its modifiers (``VABSDIFF4.U8.ACC``),
    in each kernel of a built library's SASS."""
    tool = _cuobjdump()
    if tool is None:
        raise RuntimeError("neither cuobjdump nor Triton's copy of it found")
    text = subprocess.run([tool, "-sass", str(library)], capture_output=True,
                          text=True, check=True).stdout
    out: Dict[str, Counter] = {}
    cur = None
    for line in text.splitlines():
        if "Function :" in line:
            cur = out.setdefault(line.split("Function :", 1)[1].strip(),
                                 Counter())
            continue
        m = _OPCODE.search(line)
        if cur is not None and m:
            cur[m.group(1)] += 1
    return {k: dict(v.most_common()) for k, v in out.items()}


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
            ptxas_report[stem] = compile_source(src, tmp)
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        _loaded[stem] = lib
        libraries[stem] = so
        return lib


def main(argv) -> int:
    if len(argv) < 2 or argv[0] != "--sass":
        print("usage: python -m selkies_tpu_torch._build --sass FILE.cu ...",
              file=sys.stderr)
        return 2
    report = {}
    with tempfile.TemporaryDirectory() as tmp:
        for i, src in enumerate(argv[1:]):
            so = Path(tmp) / f"lib{i}.so"
            compile_source(Path(src), so)
            report[src] = sass_opcodes(so)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))

"""Builds the port's CUDA kernels with nvcc into one shared library with a
plain C interface, and loads it with ctypes.

One nvcc call compiles every `sp_gan_tpu_torch/csrc/*.cu` for sm_90a. No
PyTorch headers, no CUTLASS and no ninja are involved, so the build takes
seconds. The library goes to `build/sp_gan_tpu_torch/` at the repository
root, named after a hash of the sources and flags: a changed source builds
anew, an unchanged one is loaded as it is. The compile writes to a private
temporary name first and `os.replace` publishes it, so two processes
building at once never load a half-written file.

Nothing here runs at import time: the first call of `library()` builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "sp_gan_tpu_torch"
NVCC_DEFAULT = Path("/usr/local/cuda/bin/nvcc")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signatures of csrc/*.cu; every function returns its cudaError_t
SIGNATURES = {
    # x, idx, dist, B, N, C, k, stream
    "spgan_knn": (_P, _P, _P, _I, _I, _I, _I, _P),
    # x, ee, idx, B, N, C, k, diff_only, packed, out_bf16, stream
    "spgan_knn_edge": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    # ee, w1, a1, w2, a2, wx, ax, wout, bout, vbuf, out, B, N, C, F2, F, k,
    # neg, stream
    "spgan_edge_tail": (_P,) * 11 + (_I,) * 6 + (_F, _P),
    # d_diff, idx, d_x, scratch, B, N, k, C, dd_bf16, stream
    "spgan_scatter_diff_bwd": (_P,) * 4 + (_I,) * 5 + (_P,),
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def find_nvcc() -> str:
    """nvcc from CUDA_HOME, then PATH, then /usr/local/cuda/bin."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        cands.append(Path(on_path))
    cands.append(NVCC_DEFAULT)
    for c in cands:
        if c.is_file() and os.access(c, os.X_OK):
            return str(c)
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        "/usr/local/cuda/bin); the port's CUDA kernels need the CUDA "
        "toolkit")


def sources() -> list:
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libspgan_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compiles the library unless it exists; returns its path. Raises with
    nvcc's stderr if the compile fails."""
    out = library_path()
    if out.exists():
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f".{out.stem}.{os.getpid()}.tmp.so")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
           *[str(s) for s in sorted(CSRC_DIR.glob("*.cu"))]]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                f"{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if tmp.exists():
            tmp.unlink()
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use, with argtypes and
    restype set for every function."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def check(err: int, name: str) -> None:
    """Raises if a kernel function returned a nonzero cudaError_t."""
    if err != 0:
        raise RuntimeError(f"{name} failed with cudaError_t {err}")

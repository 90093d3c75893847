"""Builds the port's CUDA kernels with nvcc into one shared library with a
plain C interface, and loads it with ctypes.

One nvcc process per `sp_gan_tpu_torch/csrc/*.cu`, all started together,
compiles each source for sm_90a into an object; one more links the objects
into the library. No PyTorch headers, no CUTLASS and no ninja are
involved, so the build takes as long as the slowest source. The library
goes to `build/sp_gan_tpu_torch/` at the repository root, named after a
hash of the sources and flags: a changed source builds anew, an unchanged
one is loaded as it is. The objects go to a private temporary directory
and the link to a private temporary name, which `os.replace` publishes,
so two processes building at once never load a half-written file.
`last_log` keeps ptxas's report (registers, shared memory and spills of
each kernel) of the last build in this process.

Nothing here runs at import time: the first call of `library()` builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "sp_gan_tpu_torch"
NVCC_DEFAULT = Path("/usr/local/cuda/bin/nvcc")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                              "-Xptxas", "-v", "-c")
LINK_FLAGS = ARCH_FLAGS + ("-shared",)
NVCC_FLAGS = COMPILE_FLAGS + LINK_FLAGS     # what the library's hash covers

_P, _I, _F, _L = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                  ctypes.c_longlong)
# C signatures of csrc/*.cu; every function returns its cudaError_t (or,
# for spgan_knn_scratch, spgan_knn_edge_scratch,
# spgan_knn_edge_window_scratch, spgan_edge_tail_scratch, spgan_ebt_scratch
# and spgan_csr_scratch, a count of floats or int32 as a long long,
# RESTYPES)
SIGNATURES = {
    # B, N, C, k -> int32 of scratch (long long)
    "spgan_knn_scratch": (_I,) * 4,
    # x, scratch, idx, dist, refined, B, N, C, k, mu, nu, stream
    "spgan_knn": (_P,) * 5 + (_I,) * 4 + (_F, _F, _P),
    # B, N, C, k -> int32 of scratch (long long)
    "spgan_knn_edge_scratch": (_I,) * 4,
    # x, scratch, ee, idx, refined, B, N, C, k, diff_only, packed, out_bf16,
    # mu, nu, stream
    "spgan_knn_edge": (_P,) * 5 + (_I,) * 7 + (_F, _F, _P),
    # B, N, C, k, W -> int32 of scratch (long long)
    "spgan_knn_edge_window_scratch": (_I,) * 5,
    # x, scratch, ee, idx, refined, B, N, C, k, W, low_mask, diff_only,
    # packed, out_bf16, mu, nu, stream
    "spgan_knn_edge_window": (_P,) * 5 + (_I,) * 9 + (_F, _F, _P),
    # B, N, C, F2, F, k, bf16 -> floats of scratch (long long)
    "spgan_edge_tail_scratch": (_I,) * 7,
    # B, N, C, F2, F, k, bf16 -> the design a launch takes (int)
    "spgan_edge_tail_route": (_I,) * 7,
    # ee, w1, a1, w2, a2, wx, ax, wout, bout, scratch, out, B, N, C, F2, F,
    # k, neg, bf16, stream
    "spgan_edge_tail": (_P,) * 11 + (_I,) * 6 + (_F, _I, _P),
    # pass, B, N, C, F2, F, k, bf16 -> the engine a launch takes (int)
    "spgan_ebt_route": (_I,) * 8,
    # pass, B, N, C, F2, F, k, bf16 -> floats of scratch (long long)
    "spgan_ebt_scratch": (_I,) * 8,
    # ee, w1, a1, w2, out, scratch, B, N, C, F2, F, k, neg, bf16, stream
    "spgan_ebt_stats2": (_P,) * 6 + (_I,) * 6 + (_F, _I, _P),
    # ee, d_out, w1, a1, w2, a2, wx, ax, gb2x, wout, sums, d_wout, d_bout,
    # d_u, scratch, B, N, C, F2, F, k, neg, bf16, stream
    "spgan_ebt_bwd1": (_P,) * 15 + (_I,) * 6 + (_F, _I, _P),
    # ee, d_u, w1, a1, w2, a2, wx, ax, gb2x, s2, gb1, s1, d_w2, scratch,
    # B, N, C, F2, F, k, neg, bf16, stream
    "spgan_ebt_bwd2": (_P,) * 14 + (_I,) * 6 + (_F, _I, _P),
    # ee, d_u, w1, a1, w2, a2, wx, ax, gb2x, s2, gb1, s1, d_ee, d_w1, d_wx,
    # scratch, B, N, C, F2, F, k, neg, bf16, stream
    "spgan_ebt_bwd3": (_P,) * 16 + (_I,) * 6 + (_F, _I, _P),
    # d_diff, idx, d_x, scratch, B, N, k, C, row stride, dd_bf16, stream
    "spgan_scatter_diff_bwd": (_P,) * 4 + (_I,) * 6 + (_P,),
    # g, idx, out, scratch, B, S, n, F, g_bf16, stream
    "spgan_scatter_add": (_P,) * 4 + (_I,) * 5 + (_P,),
    # B, n, S -> int32 of scratch of D, H and M (long long)
    "spgan_csr_scratch": (_I, _I, _L),
    # d_ee, idx, d_x, scratch, B, N, k, C, ee_bf16, stream
    "spgan_edge_scatter_bwd": (_P,) * 4 + (_I,) * 5 + (_P,),
    # x, y, d1, i1, d2, i2, scratch, B, N, M, C, stream
    "spgan_chamfer": (_P,) * 7 + (_I,) * 4 + (_P,),
    # d, asg, rounds, bidders, B, N, M, phases, eps (host f32[16]), iters,
    # packed, stream
    "spgan_auction_jacobi": (_P,) * 4 + (_I,) * 4 + (_P, _I, _I, _P),
    # d, asg, rounds, bidders, B, N, M, w, phases, eps (host f32[16]), cap,
    # prof, stream
    "spgan_auction": (_P,) * 4 + (_I,) * 5 + (_P, _L, _P, _P),
}

RESTYPES = {"spgan_knn_scratch": ctypes.c_longlong,
            "spgan_knn_edge_scratch": ctypes.c_longlong,
            "spgan_knn_edge_window_scratch": ctypes.c_longlong,
            "spgan_edge_tail_scratch": ctypes.c_longlong,
            "spgan_ebt_scratch": ctypes.c_longlong,
            "spgan_csr_scratch": ctypes.c_longlong}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
last_log = ""


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


def _run_all(cmds) -> list:
    """Runs the commands side by side; returns (command, returncode,
    stderr) of each, in order."""
    procs = [subprocess.Popen(c, stdout=subprocess.DEVNULL,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    errs = [p.communicate()[1] for p in procs]
    return [(c, p.returncode, e) for c, p, e in zip(cmds, procs, errs)]


def build() -> Path:
    """Compiles the library unless it exists; returns its path. Raises with
    nvcc's stderr if a compile or the link fails."""
    global last_log
    out = library_path()
    if out.exists():
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix=f".{out.stem}.", dir=BUILD_DIR))
    tmp = work / out.name
    try:
        srcs = sorted(CSRC_DIR.glob("*.cu"))
        objs = [work / f"{s.stem}.o" for s in srcs]
        runs = []
        for cmds in ([[nvcc, *COMPILE_FLAGS, "-o", str(o), str(s)]
                      for s, o in zip(srcs, objs)],
                     [[nvcc, *LINK_FLAGS, "-o", str(tmp),
                       *[str(o) for o in objs]]]):
            runs += _run_all(cmds)
            for cmd, rc, err in runs:
                if rc != 0:
                    raise RuntimeError(
                        f"nvcc failed ({rc}): {' '.join(cmd)}\n{err}")
        os.replace(tmp, out)
        last_log = "".join(err for _, _, err in runs)
    finally:
        shutil.rmtree(work, ignore_errors=True)
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
                fn.restype = RESTYPES.get(name, ctypes.c_int)
            _lib = lib
        return _lib


# cudaErrorInvalidValue, which the kernels' route and scratch queries return
# (negated) for widths they refuse
CUDA_ERROR_INVALID_VALUE = 1


def check(err: int, name: str) -> None:
    """Raises if a kernel function returned a nonzero cudaError_t."""
    if err != 0:
        raise RuntimeError(f"{name} failed with cudaError_t {err}")

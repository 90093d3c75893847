"""The port's host runtime: `spgan_native.cpp` (a copy of the JAX package's
`sp_gan_tpu/native/spgan_native.cpp`) bound with ctypes.

- `assemble_batch(data, idx, seed)`: the clouds `data[idx]`, each with its
  points in an order of its own (Fisher-Yates on C++ threads), the host
  gather of the streaming training path (`data/h5.py::epoch_batches`);
- `parse_xyz(path)`: the .xyz reader of `viz/io.py::load_xyz`;
- `save_xyz_fast(path, pc)`: the .xyz writer of the trainer's sample dumps.

The library is built with g++ on first use into `build/sp_gan_tpu_torch/`
at the repository root, named after a hash of the source and the flags, so
a changed source builds anew. A build or load failure raises with the
compiler's output: there is no numpy fallback. The numpy version that the
tests hold the gather's semantics against lives in
`tests/test_torch_trainer_parts.py`.

Nothing here runs at import time: the first call builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SRC = Path(__file__).resolve().with_name("spgan_native.cpp")
BUILD_DIR = SRC.parents[2] / "build" / "sp_gan_tpu_torch"
CXX = "g++"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
N_THREADS = 4     # the JAX package's default: the shuffles depend on it

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_F = ctypes.POINTER(ctypes.c_float)


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"libspgan_native_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compiles the library unless it exists; returns its path. Raises with
    g++'s output if the compile fails. The compile writes to a private
    temporary name that `os.replace` publishes, so two processes building
    at once never load a half-written file."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=f".{out.stem}.", suffix=".so",
                               dir=BUILD_DIR)
    os.close(fd)
    cmd = [CXX, *CXX_FLAGS, "-o", tmp, str(SRC), "-lpthread"]
    try:
        try:
            run = subprocess.run(cmd, capture_output=True, text=True,
                                 timeout=300)
        except FileNotFoundError as e:
            raise RuntimeError(f"{CXX} not found: the port's host runtime "
                               f"(sp_gan_tpu_torch/native) needs it") from e
        if run.returncode != 0:
            raise RuntimeError(f"{' '.join(cmd)} failed ({run.returncode}):"
                               f"\n{run.stdout}{run.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def library() -> ctypes.CDLL:
    """The loaded library, built on first use, with argtypes and restype set
    for every function."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.spgan_parse_xyz.restype = ctypes.c_int64
            lib.spgan_parse_xyz.argtypes = [
                ctypes.c_char_p, _F, ctypes.c_int64, ctypes.c_int32]
            lib.spgan_assemble_batch.restype = None
            lib.spgan_assemble_batch.argtypes = [
                _F, ctypes.c_int64, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
                ctypes.c_uint64, ctypes.c_int32, _F]
            lib.spgan_save_xyz.restype = ctypes.c_int64
            lib.spgan_save_xyz.argtypes = [
                ctypes.c_char_p, _F, ctypes.c_int64, ctypes.c_int32]
            _lib = lib
        return _lib


def _fp(a: np.ndarray):
    return a.ctypes.data_as(_F)


def parse_xyz(path: str, max_rows: int = 1 << 22,
              cols: int = 3) -> np.ndarray:
    """The first `cols` columns of the first `max_rows` rows of a
    whitespace-separated text file -> [rows, cols] float32. Parsing stops
    at the first row with fewer than `cols` numbers."""
    if max_rows < 0 or cols < 1:
        raise ValueError(f"max_rows={max_rows}, cols={cols}")
    out = np.empty((max_rows, cols), np.float32)
    n = library().spgan_parse_xyz(os.fsencode(path), _fp(out), max_rows,
                                  cols)
    if n < 0:
        raise FileNotFoundError(path)
    return out[:n].copy()


def _check_gather(data: np.ndarray, idx: np.ndarray) -> None:
    if data.ndim != 3 or data.shape[2] != 3:
        raise ValueError(f"data must be [M, N, 3], got {data.shape}")
    if idx.ndim != 1:
        raise ValueError(f"idx must be [bs], got {idx.shape}")
    if idx.size and (idx.min() < 0 or idx.max() >= data.shape[0]):
        raise IndexError(f"idx outside 0..{data.shape[0] - 1}")


def assemble_batch(data: np.ndarray, idx: np.ndarray, seed: int,
                   n_threads: int = N_THREADS) -> np.ndarray:
    """data [M, N, 3], idx [bs] -> [bs, N, 3] float32: `data[idx]` with
    each cloud's points shuffled. The same (data, idx, seed, n_threads)
    give the same batch as `sp_gan_tpu.native.assemble_batch`."""
    data = np.ascontiguousarray(data, np.float32)
    idx = np.ascontiguousarray(idx, np.int64)
    _check_gather(data, idx)
    bs, n_points = len(idx), data.shape[1]
    out = np.empty((bs, n_points, 3), np.float32)
    library().spgan_assemble_batch(
        _fp(data), data.shape[0], n_points,
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), bs,
        ctypes.c_uint64(seed if seed else 1), n_threads, _fp(out))
    return out


def save_xyz_fast(path: str, pc: np.ndarray) -> int:
    """Writes pc [rows, cols] as text, six decimals a number; returns the
    rows written. Raises OSError when the file cannot be opened."""
    pc = np.ascontiguousarray(pc, np.float32)
    if pc.ndim != 2:
        raise ValueError(f"pc must be [rows, cols], got {pc.shape}")
    n = library().spgan_save_xyz(os.fsencode(path), _fp(pc), pc.shape[0],
                                 pc.shape[1])
    if n < 0:
        raise OSError(f"cannot write {path}")
    return n

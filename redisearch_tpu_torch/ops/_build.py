"""Build and load the port's CUDA kernels.

`csrc/intersect.cu` has a plain C interface, so it compiles with nvcc
alone in seconds (no PyTorch headers) into a shared library that ctypes
loads.  The library lands in `redisearch_tpu_torch/_build/` (listed in
`.gitignore`) under a name carrying the hash of the source and the
flags: an edited source rebuilds, an unchanged one loads as it is.
The build runs at first use, never at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(_PKG, "csrc", "intersect.cu")
BUILD_DIR = os.path.join(_PKG, "_build")
# --fmad=false and no fast-math: the kernel must round like the plain
# torch version (see the note at the top of csrc/intersect.cu)
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
         "-Xptxas", "-v"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
#: what the last build or load did: {"path", "seconds", "log", "built"}
BUILD_INFO: dict = {}


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the intersect kernel builds with "
                       "the CUDA toolkit (CUDA_HOME or /usr/local/cuda)")


def build() -> str:
    """Compile the kernel library if this source and these flags have
    no build yet; returns its path.  Fills BUILD_INFO (the ptxas report
    of registers, shared memory and spills is under "log")."""
    with open(SRC, "rb") as f:
        src = f.read()
    tag = hashlib.sha256(src + " ".join(FLAGS).encode()).hexdigest()[:16]
    so = os.path.join(BUILD_DIR, f"libintersect_{tag}.so")
    log_path = so[:-3] + ".log"
    if os.path.exists(so):
        log = ""
        if os.path.exists(log_path):
            with open(log_path) as f:
                log = f.read()
        BUILD_INFO.update(path=so, seconds=0.0, log=log, built=False)
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *FLAGS, "-o", tmp, SRC],
                          capture_output=True, text=True, timeout=600)
    secs = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
    with open(log_path, "w") as f:
        f.write(log)
    os.replace(tmp, so)      # atomic: concurrent builders never see halves
    BUILD_INFO.update(path=so, seconds=secs, log=log, built=True)
    return so


def load() -> ctypes.CDLL:
    """The kernel library, built on first use and loaded once."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(build())
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.rs_intersect_launch.restype = i32
        lib.rs_intersect_launch.argtypes = [
            vp, i32, vp, i32,                    # meta, fmeta
            vp, vp, vp, vp, i64,                 # postings, n_post
            ctypes.POINTER(vp), ctypes.POINTER(i64),   # aux ptrs / lens
            vp,                                  # plan (host)
            vp, vp, vp, i32,                     # outputs, out_cols
            vp, vp, i32,                         # scratch, scr_cols
            i32, i32, vp]                        # B, grid, stream
        lib.rs_cuda_error_string.restype = ctypes.c_char_p
        lib.rs_cuda_error_string.argtypes = [i32]
        _lib = lib
        return lib


def error_string(err: int) -> str:
    return load().rs_cuda_error_string(err).decode()

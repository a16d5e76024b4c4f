"""Build and load the port's CUDA kernels.

Each source under `csrc/` has a plain C interface, so it compiles with
nvcc alone in seconds (no PyTorch headers) into its own shared library
that ctypes loads.  The libraries land in `redisearch_tpu_torch/_build/`
(listed in `.gitignore`) under names carrying the hash of the source and
the flags: an edited source rebuilds, an unchanged one loads as it is.
`build_all` starts one nvcc per source, all at once.  Builds run at
first use, never at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRCS = {name: os.path.join(_PKG, "csrc", f"{name}.cu")
        for name in ("intersect", "groupby", "phrase", "probes")}
BUILD_DIR = os.path.join(_PKG, "_build")
# --fmad=false and no fast-math: the kernels must round like their plain
# torch versions (see the note at the top of csrc/intersect.cu)
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
         "-Xptxas", "-v"]

_vp, _i32, _i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: each library's launch functions and their argument types
_LAUNCH = {
    "intersect": [("rs_intersect_launch", [
        _vp, _i32, _vp, _i32,                      # meta, fmeta
        _vp, _vp, _vp, _vp, _i64,                  # postings, n_post
        ctypes.POINTER(_vp), ctypes.POINTER(_i64),  # aux ptrs / lens
        _vp,                                       # plan (host)
        _vp, _vp, _vp, _i32,                       # outputs, out_cols
        _i32, _i32, _vp])],                        # B, grid, stream
    "groupby": [("rs_groupby_launch", [
        _vp, _vp, _vp,                             # gslots, vals, out
        _i32, _i32, _i64,                          # B, S, n
        _i32, _i32,                                # G_pad, want_sumsq
        _i32, _i32, _vp]),                         # grid, use_smem, stream
        ("rs_gb_single_launch", [
            _vp, _vp,                              # gid, valid
            ctypes.POINTER(_vp), ctypes.POINTER(_vp),  # pres, vals
            ctypes.POINTER(_i32), ctypes.POINTER(_i32),  # their steps
            _i32, _i64, _i32, _i32,                # n_ops, n, n_groups, G_pad
            _i32, _i32,                            # has_base, want_minmax
            _i32, _i32, _i64, _i32,                # blocks, warps, rpb, smem
            _vp, _vp, _vp])],                      # out, part, stream
    "phrase": [("rs_phrase_launch", [
        _vp, _vp,                                  # meta, fmeta
        _vp, _vp, _vp, _vp, _i64,                  # postings, n_post
        _vp, _i64,                                 # poskeys, n_keys
        _vp,                                       # params (host)
        _vp, _vp, _vp, _vp,                        # outputs, scratch
        _i32, _vp])],                              # grid, stream
    "probes": [("rs_probe_floor_launch", [
        _vp, _i32, _vp,                            # meta, its columns, fmeta
        _vp, _vp, _vp, _i32,                       # outputs, fused
        _i32, _i32,                                # G, B
        ctypes.POINTER(_vp), _i32, _vp]),          # anys (host), smem, stream
        ("rs_probe_gwin_launch", [
            _vp, _i32, _vp, _vp, _i64,             # meta, its columns, d, f
            _vp, _i32, _i32,                       # out, B, G
            _i32, _i32, _i32, _i32, _vp]),         # colmax, rows, staged
        ("rs_probe_gcols_launch", [
            _vp, _vp, _i64, _vp, _i32, _i32, _vp]),  # meta, d, out, B, G
        ("rs_probe_variant_launch", [
            _vp, _vp, _vp, _vp, _vp, _vp, _i64,    # meta, fmeta, windows
            _i32, ctypes.POINTER(_i32), _i32, _i32,  # T, rows (host), k, mode
            _vp, _vp, _vp, _i32, _vp]),            # outputs, B, stream
        ("rs_probe_ring_info", [
            _i32, _i32, _i32, ctypes.POINTER(_i32)])],  # kernel, blocks, k, out
}

_lock = threading.Lock()
_libs: dict = {}
#: per source, what the last build or load did:
#: {"path", "seconds", "log", "built"}
BUILD_INFO: dict = {}


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the kernels build with the CUDA "
                       "toolkit (CUDA_HOME or /usr/local/cuda)")


def _target(name: str) -> str:
    with open(SRCS[name], "rb") as f:
        src = f.read()
    tag = hashlib.sha256(src + " ".join(FLAGS).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"lib{name}_{tag}.so")


def build_all(names=tuple(SRCS)) -> dict:
    """Compile every library in `names` that this source and these flags
    have no build of yet, one nvcc per source, all started together;
    returns {name: path}.  Fills BUILD_INFO[name] (the ptxas report of
    registers, shared memory and spills is under "log")."""
    paths, procs = {}, {}
    for name in names:
        so = _target(name)
        paths[name] = so
        if os.path.exists(so):
            log = ""
            if os.path.exists(so[:-3] + ".log"):
                with open(so[:-3] + ".log") as f:
                    log = f.read()
            BUILD_INFO[name] = dict(path=so, seconds=0.0, log=log,
                                    built=False)
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        procs[name] = (subprocess.Popen(
            [_nvcc(), *FLAGS, "-o", tmp, SRCS[name]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, time.perf_counter())
    failed = []
    for name, (proc, tmp, t0) in procs.items():
        log, _ = proc.communicate(timeout=600)
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {name} ({proc.returncode}):\n"
                          f"{log}")
            continue
        so = paths[name]
        with open(so[:-3] + ".log", "w") as f:
            f.write(log)
        os.replace(tmp, so)    # atomic: concurrent builders never see halves
        BUILD_INFO[name] = dict(path=so, seconds=secs, log=log, built=True)
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """Library `name`, built on first use and loaded once."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        lib = ctypes.CDLL(build_all((name,))[name])
        for fn_name, argtypes in _LAUNCH[name]:
            fn = getattr(lib, fn_name)
            fn.restype = _i32
            fn.argtypes = argtypes
        lib.rs_cuda_error_string.restype = ctypes.c_char_p
        lib.rs_cuda_error_string.argtypes = [_i32]
        _libs[name] = lib
        return lib


def error_string(name: str, err: int) -> str:
    return load(name).rs_cuda_error_string(err).decode()

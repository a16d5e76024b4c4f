# Copy of redisearch_tpu/native_resp.py: the port imports nothing of the JAX package.
"""ctypes bindings for the native RESP codec (native/resp_codec.cpp).

The wire server's protocol layer (reference analog: the C command argv
machinery + reply builder, src/module.c / src/reply.c).  Compiles on
first use (g++ -O3) into the port's git-ignored
`redisearch_tpu_torch/_build/`, through a temporary file renamed into
place, so concurrent builders never load half a library; the source
stays `native/resp_codec.cpp`.  `available()` gates the asyncio server's
fallback to the pure-Python parser.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

_PKG = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(_PKG)
_SRC = os.path.join(_ROOT, "native", "resp_codec.cpp")
_SO = os.path.join(_PKG, "_build", "libresp_codec.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            if (not os.path.exists(_SO)
                    or os.path.getmtime(_SO) < os.path.getmtime(_SRC)):
                os.makedirs(os.path.dirname(_SO), exist_ok=True)
                tmp = f"{_SO}.{os.getpid()}.tmp"
                subprocess.run(
                    ["g++", "-O3", "-shared", "-fPIC", "-o", tmp, _SRC],
                    check=True, capture_output=True, timeout=300)
                os.replace(tmp, _SO)   # concurrent builders see no halves
            lib = ctypes.CDLL(_SO)
        except (OSError, subprocess.SubprocessError):
            return None
        lib.resp_parser_new.restype = ctypes.c_void_p
        lib.resp_parser_free.argtypes = [ctypes.c_void_p]
        lib.resp_parser_feed.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                         ctypes.c_int64]
        lib.resp_parser_next.restype = ctypes.c_int
        lib.resp_parser_next.argtypes = [ctypes.c_void_p]
        lib.resp_parser_argc.restype = ctypes.c_int64
        lib.resp_parser_argc.argtypes = [ctypes.c_void_p]
        lib.resp_parser_data.restype = ctypes.POINTER(ctypes.c_char)
        lib.resp_parser_data.argtypes = [ctypes.c_void_p]
        lib.resp_parser_offs.restype = ctypes.POINTER(ctypes.c_int64)
        lib.resp_parser_offs.argtypes = [ctypes.c_void_p]
        lib.resp_parser_lens.restype = ctypes.POINTER(ctypes.c_int64)
        lib.resp_parser_lens.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


class RespParser:
    """Streaming RESP command parser over the native codec.

    feed(bytes) then iterate next() -> list[str] argv | None (need more
    data).  Raises ValueError on protocol errors."""

    def __init__(self):
        lib = _load()
        if lib is None:
            raise RuntimeError("native resp codec unavailable")
        self._lib = lib
        self._p = lib.resp_parser_new()

    def __del__(self):
        try:
            if getattr(self, "_p", None):
                self._lib.resp_parser_free(self._p)
                self._p = None
        except Exception:
            pass

    def feed(self, data: bytes) -> None:
        self._lib.resp_parser_feed(self._p, data, len(data))

    def next(self):
        rc = self._lib.resp_parser_next(self._p)
        if rc == 0:
            return None
        if rc < 0:
            raise ValueError("RESP protocol error")
        n = self._lib.resp_parser_argc(self._p)
        data = self._lib.resp_parser_data(self._p)
        offs = self._lib.resp_parser_offs(self._p)
        lens = self._lib.resp_parser_lens(self._p)
        out = []
        for i in range(n):
            raw = ctypes.string_at(
                ctypes.addressof(data.contents) + offs[i], lens[i])
            out.append(raw.decode("utf-8", "surrogateescape"))
        return out

# Copy of redisearch_tpu/native.py: the port imports nothing of the JAX package.
"""ctypes bindings for the native bulk indexer (native/bulk_indexer.cpp).

Compiles the shared library on first use (g++ -O3) into the port's
git-ignored `redisearch_tpu_torch/_build/`, apart from the JAX package's
build, and caches it there.  Falls back cleanly when no toolchain is available — callers
check `available()` and use the pure-Python builder otherwise.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_PKG = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(_PKG)
_SRC = os.path.join(_ROOT, "native", "bulk_indexer.cpp")
_SO = os.path.join(_PKG, "_build", "libbulk_indexer.so")

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
                    ["g++", "-O3", "-march=native", "-shared", "-fPIC",
                     "-o", tmp, _SRC],
                    check=True, capture_output=True, timeout=300)
                os.replace(tmp, _SO)   # concurrent builders see no halves
            lib = ctypes.CDLL(_SO)
        except (OSError, subprocess.SubprocessError):
            return None
        lib.bulk_new.restype = ctypes.c_void_p
        lib.bulk_new.argtypes = [ctypes.c_char_p, ctypes.c_int]
        lib.bulk_add_doc.restype = ctypes.c_double
        lib.bulk_add_doc.argtypes = [
            ctypes.c_void_p, ctypes.c_int32, ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_float), ctypes.c_int]
        lib.bulk_sizes.argtypes = [ctypes.c_void_p,
                                   ctypes.POINTER(ctypes.c_int64)]
        lib.bulk_export.argtypes = [
            ctypes.c_void_p,
            np.ctypeslib.ndpointer(np.int32), np.ctypeslib.ndpointer(np.int32),
            np.ctypeslib.ndpointer(np.float32),
            np.ctypeslib.ndpointer(np.int32),
            np.ctypeslib.ndpointer(np.int64),
            np.ctypeslib.ndpointer(np.int32),
            ctypes.c_char_p,
            np.ctypeslib.ndpointer(np.float32),
            np.ctypeslib.ndpointer(np.float32),
            ctypes.POINTER(ctypes.c_int64)]
        lib.bulk_free.argtypes = [ctypes.c_void_p]
        for scan in ("fuzzy_scan", "wildcard_scan", "affix_scan"):
            fn = getattr(lib, scan)
            fn.restype = ctypes.c_int64
        lib.fuzzy_scan.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p, ctypes.c_int,
            np.ctypeslib.ndpointer(np.int32), ctypes.c_int64]
        lib.wildcard_scan.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p,
            np.ctypeslib.ndpointer(np.int32), ctypes.c_int64]
        lib.affix_scan.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p, ctypes.c_int,
            np.ctypeslib.ndpointer(np.int32), ctypes.c_int64]
        _lib = lib
        return _lib


def term_scan(kind: str, blob: bytes, arg: str, max_out: int,
              max_dist: int = 1):
    """Native term-dictionary scan.  kind: fuzzy | wildcard | suffix |
    infix.  Returns int32 ordinals of matching terms (blob order)."""
    lib = _load()
    if lib is None:
        return None
    out = np.zeros(max_out, np.int32)
    a = arg.encode("utf-8", "surrogatepass")
    if kind == "fuzzy":
        n = lib.fuzzy_scan(blob, len(blob), a, max_dist, out, max_out)
    elif kind == "wildcard":
        n = lib.wildcard_scan(blob, len(blob), a, out, max_out)
    elif kind == "suffix":
        n = lib.affix_scan(blob, len(blob), a, 0, out, max_out)
    elif kind == "infix":
        n = lib.affix_scan(blob, len(blob), a, 1, out, max_out)
    else:
        raise ValueError(kind)
    return out[:n]


def available() -> bool:
    return _load() is not None


class NativeTextBuilder:
    """Streams documents' TEXT fields through the native tokenizer."""

    def __init__(self, stopwords, stem: bool = True):
        lib = _load()
        if lib is None:
            raise RuntimeError("native bulk indexer unavailable")
        self._lib = lib
        blob = "\n".join(stopwords).encode("utf-8")
        self._h = lib.bulk_new(blob, 1 if stem else 0)
        self._n = 0

    def add_doc(self, texts: list[bytes], field_ids: list[int],
                weights: list[float]) -> float:
        """texts: utf-8 bytes per TEXT field of this doc."""
        nf = len(texts)
        concat = b"".join(texts)
        off = (ctypes.c_int64 * (nf + 1))()
        at = 0
        for i, t in enumerate(texts):
            off[i] = at
            at += len(t)
        off[nf] = at
        fids = (ctypes.c_int32 * nf)(*field_ids)
        ws = (ctypes.c_float * nf)(*weights)
        doclen = self._lib.bulk_add_doc(self._h, self._n, concat, off,
                                        fids, ws, nf)
        self._n += 1
        return doclen

    def finish(self):
        """Returns (terms list, term_offsets, doc_ids, freqs, masks,
        pos_offsets, positions, doc_lens, max_freqs, max_pos,
        max_postings)."""
        sizes = (ctypes.c_int64 * 6)()
        self._lib.bulk_sizes(self._h, sizes)
        n_terms, nnz, npos, blob_len, max_pos, n_docs = (
            sizes[0], sizes[1], sizes[2], sizes[3], sizes[4], sizes[5])
        term_offsets = np.zeros(n_terms + 1, np.int32)
        doc_ids = np.zeros(max(nnz, 1), np.int32)
        freqs = np.zeros(max(nnz, 1), np.float32)
        masks = np.zeros(max(nnz, 1), np.int32)
        pos_offsets = np.zeros(nnz + 1, np.int64)
        positions = np.zeros(max(npos, 1), np.int32)
        terms_blob = ctypes.create_string_buffer(int(blob_len) + 1)
        doc_lens = np.zeros(max(n_docs, 1), np.float32)
        max_freqs = np.zeros(max(n_docs, 1), np.float32)
        max_postings = ctypes.c_int64()
        self._lib.bulk_export(self._h, term_offsets, doc_ids, freqs, masks,
                              pos_offsets, positions, terms_blob, doc_lens,
                              max_freqs, ctypes.byref(max_postings))
        self._lib.bulk_free(self._h)
        self._h = None
        terms = (terms_blob.raw[:blob_len].decode("utf-8", "surrogatepass")
                 .split("\0")[:n_terms] if n_terms else [])
        return (terms, term_offsets, doc_ids[:nnz], freqs[:nnz],
                masks[:nnz], pos_offsets, positions[:npos],
                doc_lens[:n_docs], max_freqs[:n_docs], int(max_pos),
                int(max_postings.value))

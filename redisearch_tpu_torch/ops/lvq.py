"""LVQ8 compressed vectors for the host tier: encode, decode, and the scan
of a gathered uint8 slab.

Counterpart of `redisearch_tpu/ops/lvq.py`.  `lvq_encode`, `lvq_decode`
and `lvq_sq_norms` are host numpy, copies of the JAX module's.  Each
vector stores uint8 codes and a per-vector (offset, scale) pair,
``recon = offset + scale * code`` (the reference's SVS LVQ,
src/vector_index.h:17-71).  The scan computes distances against the
reconstruction with one f32 product over the codes:

    dot(q, recon) = offset * sum(q) + scale * dot(q, codes)

with ||recon||^2 precomputed, so L2, IP and COSINE take the forms of the
uncompressed scan (`ops/ivf.py` `_scan_tiles`).  The product runs with
TF32 off (`ops/vector.py` `_ieee_f32`), the JAX module's
`Precision.HIGHEST`.
"""

from __future__ import annotations

import numpy as np
import torch

from .vector import _ieee_f32


def lvq_encode(vecs: np.ndarray) -> tuple:
    """Encode rows to (codes u8[..., D], off f32[...], scl f32[...]).

    Works on any leading shape ([N, D] columns or [nlist, L, D] bucket
    slabs).  Constant rows encode with scale 0 and reconstruct exactly.
    """
    v = np.asarray(vecs, np.float32)
    mn = v.min(axis=-1)
    mx = v.max(axis=-1)
    scl = (mx - mn) / 255.0
    safe = np.where(scl > 0, scl, 1.0)
    codes = np.clip(
        np.rint((v - mn[..., None]) / safe[..., None]), 0, 255
    ).astype(np.uint8)
    codes = np.where((scl > 0)[..., None], codes, 0)
    return codes, mn.astype(np.float32), scl.astype(np.float32)


def lvq_decode(codes: np.ndarray, off: np.ndarray,
               scl: np.ndarray) -> np.ndarray:
    """Reconstruct f32 rows (host-side; slab rebuild and tests)."""
    return (off[..., None]
            + scl[..., None] * codes.astype(np.float32))


def lvq_sq_norms(codes: np.ndarray, off: np.ndarray, scl: np.ndarray,
                 chunk: int = 65536) -> np.ndarray:
    """||recon||^2 per row without materializing the full decode.

    sum((off + scl*c)^2) = D*off^2 + 2*off*scl*sum(c) + scl^2*sum(c^2)
    """
    flat = codes.reshape(-1, codes.shape[-1])
    o = off.reshape(-1).astype(np.float64)
    s = scl.reshape(-1).astype(np.float64)
    D = flat.shape[-1]
    out = np.empty(flat.shape[0], np.float64)
    for i in range(0, flat.shape[0], chunk):
        c = flat[i:i + chunk].astype(np.float64)
        s1 = c.sum(axis=1)
        s2 = (c * c).sum(axis=1)
        out[i:i + chunk] = (D * o[i:i + chunk] ** 2
                            + 2.0 * o[i:i + chunk] * s[i:i + chunk] * s1
                            + s[i:i + chunk] ** 2 * s2)
    return out.reshape(codes.shape[:-1]).astype(np.float32)


def lvq_dots(tiles, toff, tscl, qf):
    """dot(q, recon) of each code row: tiles u8[C, P, L, d], toff/tscl
    [C, P, L], qf f32[C, d] -> [C, P, L]."""
    with _ieee_f32():
        dots_c = torch.einsum("cpld,cd->cpl", tiles.to(torch.float32), qf)
    return toff * qf.sum(dim=1)[:, None, None] + tscl * dots_c


def scan_tiles_lvq(tiles, toff, tscl, tsq, tids, qf, k: int, metric: str,
                   cand_docs=None, cand_valid=None, doc_ok=None):
    """Exact-against-reconstruction distances + top-k over gathered u8
    list tiles of one query, the compressed twin of `ops/ivf.py`
    `_scan_tiles`.  tiles u8[P, L, d], toff/tscl/tsq/tids [P, L]; qf is
    pre-normalized for COSINE."""
    from .ivf import _scan_tiles_batch

    return tuple(t[0] for t in _scan_tiles_batch(
        lvq_dots(tiles[None], toff[None], tscl[None], qf[None]),
        tsq[None], tids[None], qf[None], k, metric,
        None if cand_docs is None else cand_docs[None],
        None if cand_valid is None else cand_valid[None], doc_ok))


def scan_slab_lvq(slab_c, slab_off, slab_scl, slab_sq, slab_ids, rowmap,
                  Q, k: int, metric: str, cand_docs, cand_valid, doc_ok,
                  has_cand: bool, has_ok: bool):
    """The scan over a gathered COMPRESSED slab (the LVQ twin of
    `ops/ivf.py` `_scan_slab`): each query's lists are rows `rowmap[b]`
    of the slab.  Returns device (dists [B, k], ids [B, k])."""
    from .ivf import _scan_slab_chunks

    def dots(rm, qf):
        return lvq_dots(slab_c[rm], slab_off[rm], slab_scl[rm], qf)

    return _scan_slab_chunks(dots, slab_sq, slab_ids, slab_c.shape[1:],
                             rowmap, Q, k, metric, cand_docs, cand_valid,
                             doc_ok, has_cand, has_ok)

"""Vector similarity: brute-force (FLAT) distance scans and top-k.

Counterpart of `redisearch_tpu/ops/vector.py`, with its distance
conventions (VecSim's):

    L2     -> squared euclidean distance (lower = closer)
    IP     -> 1 - <a, b>                  (lower = closer)
    COSINE -> 1 - cos(a, b)               (lower = closer)

and its precision contract:

* int8/uint8 storage with a query of the same type: exact integer dot
  products (the JAX function accumulates int8 x int8 in int32).  CUDA has
  no int32 `mm` for these shapes, and f32 sums lose integers past 2**24
  (255 * 255 * 259 already does), so the product runs in float64, which
  holds every such sum exactly in any order.
* bf16 storage: the bf16 query times the bf16 matrix, summed in f32 (the
  JAX function's `preferred_element_type=f32`).  `torch.mm` of two bf16
  tensors returns bf16, rounding every dot product to 8 bits; so on the
  card the product asks for an f32 output (`out_dtype`), and elsewhere
  both operands are widened to f32 (a bf16 product is exact in f32).
* everything else (f16, f32 storage): f32 operands, f32 sums, with TF32
  switched off for the call whatever the caller set (`_ieee_f32`): the
  JAX function's `Precision.HIGHEST`.  Its `approx=True` (one-pass bf16
  on the TPU's MXU, full f32 on its CPU) has no counterpart: the
  two-phase scans read the bf16 scan copy, and f32 operands run in full
  f32 here.

Masked lanes carry BIG = 3.4e38; every consumer drops lanes at or above
3.3e38.  Top-k is `ops.text.fast_top_k`: exact, lowest lane first among
ties.  `knn_scan_batches` is a Python loop over the chunk axis (the JAX
function's `lax.scan`).
"""

from __future__ import annotations

import contextlib

import torch

from .text import fast_top_k

BIG = 3.4e38


@contextlib.contextmanager
def _ieee_f32():
    """f32 matrix products in full f32 (no TF32) for the enclosed calls,
    restoring the caller's setting after."""
    prev = torch.get_float32_matmul_precision()
    if prev == "highest":
        yield
        return
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def _bf16_mm(a, b_t):
    """bf16 a [m, d] times bf16 b_t [d, n], summed and returned in f32."""
    if a.is_cuda:
        return torch.mm(a, b_t, out_dtype=torch.float32)
    with _ieee_f32():
        return torch.mm(a.float(), b_t.float())


def _scores(vecs: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """<vecs, q> along d: vecs [n, d], q [d] -> [n] or q [B, d] -> [B, n],
    f32 (see the module docstring for each storage type's route)."""
    one = q.dim() == 1
    q2 = q[None, :] if one else q
    if vecs.dtype in (torch.int8, torch.uint8) and q.dtype == vecs.dtype:
        out = torch.mm(q2.double(), vecs.double().t()).float()
    elif vecs.dtype == torch.bfloat16:
        out = _bf16_mm(q2.to(torch.bfloat16), vecs.t())
    else:
        with _ieee_f32():
            out = torch.mm(q2.float(), vecs.float().t())
    return out[0] if one else out


def distances_to(vecs: torch.Tensor, sq_norms: torch.Tensor,
                 q: torch.Tensor, metric: str) -> torch.Tensor:
    """Distance of every row of `vecs` to query `q` ([n] or [B, n])."""
    dots = _scores(vecs, q)
    qf = q.float()
    if metric == "L2":
        qsq = torch.sum(qf ** 2, dim=-1)
        if q.dim() == 1:
            return sq_norms - 2.0 * dots + qsq
        return sq_norms[None, :] - 2.0 * dots + qsq[:, None]
    if metric == "IP":
        return 1.0 - dots
    if metric == "COSINE":
        qn = torch.sqrt(torch.sum(qf ** 2, dim=-1))
        vn = torch.sqrt(torch.clamp(sq_norms, min=1e-30))
        if q.dim() == 1:
            return 1.0 - dots / (vn * torch.clamp(qn, min=1e-30))
        return 1.0 - dots / (vn[None, :] * torch.clamp(qn[:, None],
                                                       min=1e-30))
    raise ValueError(f"bad metric {metric}")


def _rescore(vecs, sq_norms, q, idx, metric):
    """Exact f32 distances at gathered candidate rows idx ([C] for q [d],
    [B, C] for q [B, d]): the JAX function's Precision.HIGHEST einsum."""
    g = vecs[idx.long()].float()                     # [..., C, d]
    qf = q.float()
    with _ieee_f32():
        if q.dim() == 1:
            dots = torch.mv(g, qf)
        else:
            dots = torch.bmm(g, qf[:, :, None])[..., 0]
    sq = sq_norms[idx.long()]
    if metric == "L2":
        qsq = torch.sum(qf ** 2, dim=-1)
        return sq - 2.0 * dots + (qsq if q.dim() == 1 else qsq[:, None])
    if metric == "IP":
        return 1.0 - dots
    qn = torch.clamp(torch.sqrt(torch.sum(qf ** 2, dim=-1)), min=1e-30)
    vn = torch.sqrt(torch.clamp(sq, min=1e-30))
    return 1.0 - dots / (vn * (qn if q.dim() == 1 else qn[:, None]))


def _cand_k(n: int, k: int) -> int:
    """Candidate-set size for the two-phase f32 path."""
    return min(n, max(4 * k, k + 16))


def _cand_top(dm: torch.Tensor, C: int):
    """Candidate top-C for the two-phase path.  As in the JAX function,
    rows wider than 4,096 lanes are ranked on a bf16 copy (the
    candidates only gate which rows are rescored); masked lanes (-BIG)
    become -inf there and rank last."""
    if dm.dim() > 1 and dm.shape[-1] > 4096:
        vals, idx = fast_top_k(dm.to(torch.bfloat16), C)
        return vals.float(), idx
    return fast_top_k(dm, C)


def _two_phase(vecs, k: int) -> bool:
    return (vecs.dtype == torch.float32
            and _cand_k(vecs.shape[0], k) < vecs.shape[0])


def _finish(vecs, sq_norms, Q, dm, k: int, metric: str, two_phase: bool):
    """Top-k of the masked distances dm ([n] or [B, n]): directly, or the
    candidate top-C, its exact rescore and the final top-k."""
    if not two_phase:
        vals, idx = fast_top_k(-dm, k)
        return -vals, idx
    C = _cand_k(vecs.shape[0], k)
    avals, aidx = _cand_top(-dm, C)
    dr = torch.where(-avals >= BIG * 0.5, BIG,
                     _rescore(vecs, sq_norms, Q, aidx, metric))
    vals, sel = fast_top_k(-dr, k)
    if dm.dim() == 1:
        return -vals, aidx[sel]
    return -vals, torch.gather(aidx, 1, sel)


def knn(vecs: torch.Tensor, sq_norms: torch.Tensor, present: torch.Tensor,
        q: torch.Tensor, k: int, metric: str,
        mask: torch.Tensor | None = None,
        scan_vecs: torch.Tensor | None = None):
    """Top-k nearest to one query: (dists [k], idx [k]).  f32 storage is
    two-phase: the bf16 scan copy (`scan_vecs`, or `vecs`) picks C =
    max(4k, k+16) candidates, an exact f32 rescore ranks them.  Other
    dtypes rank the full scan directly."""
    valid = present if mask is None else (present & mask)
    two_phase = _two_phase(vecs, k)
    sv = scan_vecs if (two_phase and scan_vecs is not None) else vecs
    d = distances_to(sv, sq_norms, q, metric)
    dm = torch.where(valid, d, BIG)
    return _finish(vecs, sq_norms, q, dm, k, metric, two_phase)


def knn_batch(vecs: torch.Tensor, sq_norms: torch.Tensor,
              present: torch.Tensor, Q: torch.Tensor, k: int, metric: str,
              mask: torch.Tensor | None = None,
              scan_vecs: torch.Tensor | None = None):
    """Batched KNN: Q [B, d] -> (dists [B, k], idx [B, k]), one [B, d] x
    [d, N] product; the same precision contract as `knn`."""
    valid = present if mask is None else (present & mask)
    return knn_batch_masked(vecs, sq_norms, valid[None, :], Q, k, metric,
                            scan_vecs=scan_vecs)


def knn_batch_masked(vecs: torch.Tensor, sq_norms: torch.Tensor,
                     valid2d: torch.Tensor, Q: torch.Tensor, k: int,
                     metric: str,
                     scan_vecs: torch.Tensor | None = None):
    """Batched filtered KNN: a per-query validity mask valid2d bool[B, N]
    (or [1, N]) applied to the shared distance product.  Q [B, d] ->
    (dists [B, k], idx [B, k]); the same precision contract as `knn`."""
    two_phase = _two_phase(vecs, k)
    sv = scan_vecs if (two_phase and scan_vecs is not None) else vecs
    d = distances_to(sv, sq_norms, Q, metric)
    dm = torch.where(valid2d, d, BIG)
    return _finish(vecs, sq_norms, Q, dm, k, metric, two_phase)


def knn_scan_batches(vecs: torch.Tensor, sq_norms: torch.Tensor,
                     present: torch.Tensor, Qc: torch.Tensor, k: int,
                     metric: str, mask: torch.Tensor | None = None,
                     scan_vecs: torch.Tensor | None = None):
    """Chunked batched KNN: Qc [it, B, d] -> (dists [it, B, k], idx
    [it, B, k]), one `knn_batch` a chunk."""
    outs = [knn_batch(vecs, sq_norms, present, Qc[i], k, metric,
                      mask=mask, scan_vecs=scan_vecs)
            for i in range(Qc.shape[0])]
    return (torch.stack([o[0] for o in outs]),
            torch.stack([o[1] for o in outs]))


def range_query(vecs: torch.Tensor, sq_norms: torch.Tensor,
                present: torch.Tensor, q: torch.Tensor, radius: float,
                metric: str):
    """VecSimIndex_RangeQuery analog: (bool mask, distances)."""
    d = distances_to(vecs, sq_norms, q, metric)
    return present & (d <= radius), d

"""IVF partitioned vector index: k-means lists on the device, and the host
tier whose list slabs stay in host memory.

Counterpart of `redisearch_tpu/ops/ivf.py`, with its functions and
names.  k-means centroids route each query to `nprobe` lists; lists are
stored bucket-major as dense [nlist, list_pad, d] tiles, so a probe is a
product over gathered tiles.  Recall is tuned by nprobe (EF_RUNTIME).
The host tier (`HostIVF`) keeps the tiles in host memory and the
centroids on the device: a batch probes on the device, gathers the
probed lists' slabs on the host in one `np.take` into pinned staging
buffers, copies them up and scans them there.

Where the port differs, and why no result does:

* `kmeans_step` sums with `index_add_`; float atomics on the card sum in
  no fixed order, so centroids may differ between runs and from the JAX
  package's.  Parity tests carry the JAX package's centroids across
  (`centroids=`), and then lists, layouts and results are equal.
* `_build_buckets` lays lists out by a stable argsort of the assignment
  (the JAX function's Python loop over rows gives the same layout), and
  assigns rows a block of 65,536 at a time.
* the scans (`_scan_tiles`, `_scan_slab`, `ivf_probe_batch`) take as
  many queries at once as keep the gathered [C, nprobe, list_pad, d]
  tiles under the JAX function's 256 MB budget (its `lax.map` takes one
  at a time; each query's result is its own either way).  f32 products
  run with TF32 off (`Precision.HIGHEST`); top-k is `ops.text.fast_top_k`
  (ties by the lowest lane, as `lax.top_k`).  Padded lanes (`tids < 0`)
  read BIG = 3.4e38; consumers drop them by distance.

`kmeans_step_sharded` (a data-parallel step over a mesh) is left to
ROADMAP A12.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from ..index.segment import next_pow2
from .lvq import lvq_decode, lvq_sq_norms
from .text import fast_top_k
from .vector import BIG, _ieee_f32

#: the JAX functions' budget for gathered list tiles, bytes
_TILE_BUDGET = 1 << 28
#: rows assigned to lists at a time while building
_ASSIGN_CHUNK = 65536


# ---------------------------------------------------------------------------
# k-means training
# ---------------------------------------------------------------------------

def kmeans_step(x: torch.Tensor, cents: torch.Tensor):
    """One Lloyd iteration.  x [n, d] f32, cents [c, d] f32.

    Returns (new_cents, assignment, shift).  Assignment by one product
    (argmin ||x-c||^2 = argmax 2xc - ||c||^2; ties to the lowest list)."""
    with _ieee_f32():
        csq = torch.sum(cents * cents, dim=1)
        scores = 2.0 * (x @ cents.T) - csq[None, :]
    assign = torch.argmax(scores, dim=1)
    c = cents.shape[0]
    sums = torch.zeros_like(cents).index_add_(0, assign, x)
    counts = torch.zeros(c, dtype=torch.float32, device=x.device).index_add_(
        0, assign, torch.ones(x.shape[0], dtype=torch.float32,
                              device=x.device))
    new = torch.where(counts[:, None] > 0,
                      sums / torch.clamp(counts, min=1.0)[:, None], cents)
    shift = torch.sqrt(torch.sum((new - cents) ** 2, dim=1)).max()
    return new, assign, shift


def train_kmeans(x: np.ndarray, nlist: int, iters: int = 10,
                 seed: int = 0, sample: int = 262144,
                 device="cpu") -> np.ndarray:
    """Subsample on the host, then Lloyd steps on `device`."""
    rng = np.random.default_rng(seed)
    n = x.shape[0]
    if n > sample:
        idx = rng.choice(n, sample, replace=False)
        xs = x[idx]
    else:
        xs = x
    init = xs[rng.choice(xs.shape[0], nlist, replace=xs.shape[0] < nlist)]
    cents = torch.as_tensor(np.asarray(init, np.float32), device=device)
    xd = torch.as_tensor(np.ascontiguousarray(xs, np.float32), device=device)
    for _ in range(iters):
        cents, _, shift = kmeans_step(xd, cents)
        if float(shift) < 1e-4:
            break
    return cents.cpu().numpy()


# ---------------------------------------------------------------------------
# IVF index
# ---------------------------------------------------------------------------

def _assign(rows, n: int, cents: np.ndarray,
            csq: np.ndarray) -> np.ndarray:
    """Each of n rows' list: argmax 2xc - ||c||^2 in host f32, a block
    of rows at a time (`rows(lo, hi)` gives rows lo..hi)."""
    assign = np.zeros(n, np.int64)
    for i in range(0, n, _ASSIGN_CHUNK):
        assign[i:i + _ASSIGN_CHUNK] = np.argmax(
            2.0 * (rows(i, i + _ASSIGN_CHUNK) @ cents.T) - csq[None, :],
            axis=1)
    return assign


def _layout(assign: np.ndarray, nlist: int):
    """Bucket-major placement: (list_pad, list of each row in list order,
    slot of each row within its list, rows in list order).  Rows keep
    their order within a list, as the JAX function's loop places them."""
    counts = np.bincount(assign, minlength=nlist)
    list_pad = max(int(counts.max()) if counts.size else 0, 1)
    list_pad = ((list_pad + 127) // 128) * 128
    order = np.argsort(assign, kind="stable")
    lists = assign[order]
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slots = np.arange(order.shape[0]) - starts[lists]
    return list_pad, lists, slots, order


def _row_sq(bv: np.ndarray) -> np.ndarray:
    """np.sum(bv * bv, axis=2), a block of lists at a time."""
    out = np.empty(bv.shape[:2], np.float32)
    for i in range(0, bv.shape[0], 64):
        b = bv[i:i + 64]
        out[i:i + 64] = np.sum(b * b, axis=2)
    return out


def _build_buckets(vecs: np.ndarray, present: np.ndarray, metric: str,
                   nlist: int = 0, iters: int = 10,
                   centroids: Optional[np.ndarray] = None, device="cpu"):
    """Shared bucket construction: train (or reuse) centroids, assign
    every present vector, lay lists out bucket-major with 128-aligned
    padding.  Returns host numpy (cents, csq, bv, bsq, bi, nlist,
    list_pad, d)."""
    sel = np.nonzero(np.asarray(present))[0]
    x = np.asarray(vecs, np.float32)[sel]
    n, d = x.shape
    xn = x
    if metric == "COSINE":
        xn = x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True),
                            1e-30)
    if centroids is None:
        if nlist <= 0:
            nlist = max(int(np.sqrt(max(n, 1))), 1)
        cents = train_kmeans(xn, nlist, iters, device=device)
    else:
        cents = np.asarray(centroids, np.float32)
        nlist = cents.shape[0]
    csq = np.sum(cents * cents, axis=1)
    assign = _assign(lambda lo, hi: xn[lo:hi], n, cents, csq)
    list_pad, lists, slots, order = _layout(assign, nlist)
    bv = np.zeros((nlist, list_pad, d), np.float32)
    bi = np.full((nlist, list_pad), -1, np.int32)
    bv[lists, slots] = x[order]
    bi[lists, slots] = sel[order]
    return (cents, csq.astype(np.float32), bv, _row_sq(bv), bi, nlist,
            list_pad, d)


@dataclasses.dataclass
class IVFIndex:
    """Bucket-major IVF storage of one vector field of one segment, on
    the segment's device."""

    centroids: Any        # f32[nlist, d]
    cent_sq: Any          # f32[nlist]
    bucket_vecs: Any      # f32[nlist, list_pad, d]
    bucket_sq: Any        # f32[nlist, list_pad]
    bucket_ids: Any       # int32[nlist, list_pad]  local doc id, -1 pad
    nlist: int
    list_pad: int
    dim: int
    metric: str

    @classmethod
    def build(cls, vecs: np.ndarray, present: np.ndarray, metric: str,
              nlist: int = 0, iters: int = 10, dtype=torch.float32,
              centroids: Optional[np.ndarray] = None,
              device="cpu") -> "IVFIndex":
        (cents, csq, bv, bsq, bi, nlist, list_pad, d) = _build_buckets(
            vecs, present, metric, nlist, iters, centroids=centroids,
            device=device)

        def dev(a, dt=None):
            return torch.as_tensor(np.array(a), dtype=dt, device=device)
        return cls(centroids=dev(cents), cent_sq=dev(csq),
                   bucket_vecs=dev(bv, dtype), bucket_sq=dev(bsq),
                   bucket_ids=dev(bi), nlist=nlist, list_pad=list_pad,
                   dim=d, metric=metric)

    def memory_bytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in (
            self.bucket_vecs, self.bucket_sq, self.bucket_ids,
            self.centroids))


@dataclasses.dataclass
class HostIVF:
    """The host tier: IVF bucket slabs in HOST memory, the centroid table
    on the device.  A batch probes on the device, gathers the probed
    lists' slabs on the host (one `np.take` per array, into pinned
    staging buffers reused across batches) and scans them on the device
    after one copy each.  Recall equals the device IVF's at equal nprobe
    (same centroids, same math); only the residency differs.  With
    compression "LVQ8" the slabs hold uint8 codes and the per-vector
    (offset, scale) pair, and bucket_sq the reconstructions' squared
    norms (ops/lvq.py)."""

    centroids: Any           # DEVICE f32[nlist, d]
    cent_sq: Any             # DEVICE f32[nlist]
    bucket_vecs: np.ndarray  # HOST f32[nlist, list_pad, d] (u8 if LVQ8)
    bucket_sq: np.ndarray    # HOST f32[nlist, list_pad]
    bucket_ids: np.ndarray   # HOST int32[nlist, list_pad]
    nlist: int
    list_pad: int
    dim: int
    metric: str
    compression: str = ""
    bucket_off: Optional[np.ndarray] = None   # HOST f32[nlist, list_pad]
    bucket_scl: Optional[np.ndarray] = None   # HOST f32[nlist, list_pad]
    # pinned staging buffers by (array, next_pow2(lists)): a batch's
    # gather lands in one, and the copy to the card reads it
    _staging: dict = dataclasses.field(default_factory=dict, repr=False)

    @classmethod
    def build(cls, vecs: np.ndarray, present: np.ndarray, metric: str,
              nlist: int = 0, iters: int = 10,
              centroids: Optional[np.ndarray] = None,
              device="cpu") -> "HostIVF":
        (cents, csq, bv, bsq, bi, nlist, list_pad, d) = _build_buckets(
            vecs, present, metric, nlist, iters, centroids=centroids,
            device=device)
        return cls(centroids=torch.as_tensor(np.array(cents), device=device),
                   cent_sq=torch.as_tensor(csq, device=device),
                   bucket_vecs=bv, bucket_sq=bsq, bucket_ids=bi,
                   nlist=nlist, list_pad=list_pad, dim=d, metric=metric)

    @classmethod
    def build_lvq(cls, codes: np.ndarray, off: np.ndarray,
                  scl: np.ndarray, present: np.ndarray, metric: str,
                  nlist: int = 0, iters: int = 10,
                  centroids: Optional[np.ndarray] = None,
                  device="cpu") -> "HostIVF":
        """Bucket layout over LVQ8 codes: centroids train and rows assign
        on the reconstructions (decoded a block at a time), the slabs
        store the codes; scan distances are exact against the
        reconstruction."""
        sel = np.nonzero(np.asarray(present))[0]
        c_all = np.asarray(codes)[sel]
        o_all = np.asarray(off, np.float32)[sel]
        s_all = np.asarray(scl, np.float32)[sel]
        n, d = c_all.shape

        def decode(lo, hi):
            x = lvq_decode(c_all[lo:hi], o_all[lo:hi], s_all[lo:hi])
            if metric == "COSINE":
                x /= np.maximum(
                    np.linalg.norm(x, axis=1, keepdims=True), 1e-30)
            return x

        if centroids is None:
            if nlist <= 0:
                nlist = max(int(np.sqrt(max(n, 1))), 1)
            cents = train_kmeans(decode(0, n), nlist, iters, device=device)
        else:
            cents = np.asarray(centroids, np.float32)
            nlist = cents.shape[0]
        csq = np.sum(cents * cents, axis=1).astype(np.float32)
        assign = _assign(decode, n, cents, csq)
        list_pad, lists, slots, order = _layout(assign, nlist)
        bc = np.zeros((nlist, list_pad, d), np.uint8)
        bo = np.zeros((nlist, list_pad), np.float32)
        bs = np.zeros((nlist, list_pad), np.float32)
        bi = np.full((nlist, list_pad), -1, np.int32)
        bc[lists, slots] = c_all[order]
        bo[lists, slots] = o_all[order]
        bs[lists, slots] = s_all[order]
        bi[lists, slots] = sel[order]
        return cls(centroids=torch.as_tensor(np.array(cents), device=device),
                   cent_sq=torch.as_tensor(csq, device=device),
                   bucket_vecs=bc, bucket_sq=lvq_sq_norms(bc, bo, bs),
                   bucket_ids=bi, nlist=nlist, list_pad=list_pad, dim=d,
                   metric=metric, compression="LVQ8", bucket_off=bo,
                   bucket_scl=bs)

    def device_bytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.centroids, self.cent_sq))

    def host_bytes(self) -> int:
        extra = ((self.bucket_off.nbytes + self.bucket_scl.nbytes)
                 if self.compression else 0)
        return (self.bucket_vecs.nbytes + self.bucket_sq.nbytes
                + self.bucket_ids.nbytes + extra)

    def _arrays(self) -> dict:
        out = {"v": self.bucket_vecs, "sq": self.bucket_sq,
               "ids": self.bucket_ids}
        if self.compression:
            out["off"] = self.bucket_off
            out["scl"] = self.bucket_scl
        return out

    def gather(self, uniq: np.ndarray) -> dict:
        """The probed lists' slabs on the host: one `np.take` per array
        into a staging buffer of next_pow2(len(uniq)) lists (pinned when
        the centroids lie on the card).  Returns {name: tensor [U, ...]}
        views of the buffers."""
        U = len(uniq)
        pin = self.centroids.is_cuda
        out = {}
        for name, arr in self._arrays().items():
            key = (name, next_pow2(U))
            buf = self._staging.get(key)
            if buf is None:
                buf = torch.empty((key[1],) + arr.shape[1:],
                                  dtype=torch.from_numpy(arr[:0]).dtype,
                                  pin_memory=pin)
                self._staging[key] = buf
            np.take(arr, uniq, axis=0, out=buf.numpy()[:U], mode="clip")
            out[name] = buf[:U]
        return out

    def upload(self, slabs: dict) -> dict:
        """The gathered slabs on the centroids' device (copies from pinned
        memory run asynchronously on the current stream)."""
        dev = self.centroids.device
        return {name: t.to(dev, non_blocking=True)
                for name, t in slabs.items()}


def _scan_tiles_batch(dots, tsq, tids, qf, k: int, metric: str,
                      cand_docs=None, cand_valid=None, doc_ok=None):
    """The distances and top-k of C queries over their gathered list
    tiles, given each row's dot product with its query: dots, tsq, tids
    [C, P, L]; qf [C, d] (pre-normalized for COSINE); cand_docs /
    cand_valid [C, Wc] sorted candidate windows.  Returns (dists [C, k],
    ids [C, k])."""
    C = dots.shape[0]
    if metric == "L2":
        d = tsq - 2.0 * dots + torch.sum(qf * qf, dim=1)[:, None, None]
    elif metric == "IP":
        d = 1.0 - dots
    else:  # COSINE (vectors stored unnormalized; normalize via tsq)
        d = 1.0 - dots / torch.clamp(torch.sqrt(tsq), min=1e-30)
    valid = tids >= 0
    if doc_ok is not None:
        cid = tids.clamp(0, doc_ok.shape[0] - 1).long()
        valid = valid & doc_ok[cid]
    flat_i = tids.reshape(C, -1)
    if cand_docs is not None:
        Wc = cand_docs.shape[1]
        pos = torch.searchsorted(cand_docs.contiguous(),
                                 flat_i.contiguous()).clamp(0, Wc - 1)
        hit = torch.gather(cand_docs, 1, pos) == flat_i
        if cand_valid is not None:
            hit = hit & torch.gather(cand_valid, 1, pos)
        valid = valid & hit.reshape(tids.shape)
    flat_d = torch.where(valid, d, BIG).reshape(C, -1)
    kk = min(k, flat_d.shape[1])
    vals, sel = fast_top_k(-flat_d, kk)
    return -vals, torch.gather(flat_i, 1, sel)


def _tile_dots(tiles, qf):
    """<row, q> of every tile row: tiles [C, P, L, d], qf [C, d] ->
    [C, P, L], in f32 with TF32 off."""
    with _ieee_f32():
        return torch.einsum("cpld,cd->cpl", tiles.to(torch.float32), qf)


def _normalize(Qf, metric: str):
    if metric == "COSINE":
        return Qf / torch.clamp(torch.linalg.norm(Qf, dim=-1, keepdim=True),
                                min=1e-30)
    return Qf


def _scan_tiles(tiles, tsq, tids, qf, k: int, metric: str,
                cand_docs=None, cand_valid=None, doc_ok=None):
    """Exact distances + top-k over one query's gathered list tiles, the
    shared tail of the device probe and the host-tier slab scan.  tiles
    [P, L, d], tsq/tids [P, L]; qf is pre-normalized for COSINE."""
    return tuple(t[0] for t in _scan_tiles_batch(
        _tile_dots(tiles[None], qf[None]), tsq[None], tids[None],
        qf[None], k, metric,
        None if cand_docs is None else cand_docs[None],
        None if cand_valid is None else cand_valid[None], doc_ok))


def ivf_probe_arrays(centroids, cent_sq, bucket_vecs, bucket_sq, bucket_ids,
                     metric: str, q, k: int, nprobe: int,
                     cand_docs=None, cand_valid=None):
    """KNN of one query by centroid routing over raw arrays.  Returns
    (dists [k], local_ids [k]).  Filtered KNN: `cand_docs` is a sorted
    candidate window and probed ids are tested against it with
    searchsorted (the reference's hybrid iterator,
    src/iterators/hybrid_reader.c)."""
    qf = _normalize(q.to(torch.float32), metric)
    with _ieee_f32():
        cd = cent_sq - 2.0 * (centroids @ qf)
    _, lists = fast_top_k(-cd, min(nprobe, centroids.shape[0]))
    return _scan_tiles(bucket_vecs[lists], bucket_sq[lists],
                       bucket_ids[lists], qf, k, metric, cand_docs,
                       cand_valid)


def ivf_probe(ivf: IVFIndex, q, k: int, nprobe: int,
              cand: Optional[tuple] = None):
    """`ivf_probe_arrays` over an IVFIndex."""
    cd, cv = cand if cand is not None else (None, None)
    return ivf_probe_arrays(ivf.centroids, ivf.cent_sq, ivf.bucket_vecs,
                            ivf.bucket_sq, ivf.bucket_ids, ivf.metric,
                            q, k, nprobe, cd, cv)


def _chunk(B: int, nprobe: int, list_pad: int, d: int) -> int:
    """Queries a scan takes at once: the gathered [C, nprobe, list_pad,
    d] f32 tiles stay within the JAX functions' 256 MB budget."""
    per = nprobe * list_pad * d * 4
    return int(max(1, min(B, _TILE_BUDGET // max(per, 1))))


def ivf_probe_batch(ivf: IVFIndex, Q, k: int, nprobe: int):
    """Batched probe: each chunk of queries (`_chunk`) routes, gathers
    its [C, nprobe, list_pad, d] tiles and scans them.  Returns device
    (dists [B, k], ids [B, k])."""
    B, d = Q.shape
    nprobe = min(nprobe, ivf.nlist)
    C = _chunk(B, nprobe, ivf.list_pad, d)
    outs = []
    for c0 in range(0, B, C):
        lists = _probe_lists(ivf.centroids, ivf.cent_sq, Q[c0:c0 + C],
                             nprobe, ivf.metric)
        qf = _normalize(Q[c0:c0 + C].to(torch.float32), ivf.metric)
        outs.append(_scan_tiles_batch(
            _tile_dots(ivf.bucket_vecs[lists], qf), ivf.bucket_sq[lists],
            ivf.bucket_ids[lists], qf, k, ivf.metric))
    return (torch.cat([o[0] for o in outs]),
            torch.cat([o[1] for o in outs]))


# ---------------------------------------------------------------------------
# Host-tier (beyond device memory) query path
# ---------------------------------------------------------------------------

def _probe_lists(centroids, cent_sq, Q, nprobe: int, metric: str):
    """Each query's top-nprobe list ids [B, nprobe]: a [B, nlist]
    product with the centroid table."""
    Qf = _normalize(Q.to(torch.float32), metric)
    with _ieee_f32():
        cd = cent_sq[None, :] - 2.0 * (Qf @ centroids.T)
    return fast_top_k(-cd, nprobe)[1]


def _scan_slab_chunks(dots_fn, slab_sq, slab_ids, tile_shape, rowmap, Q,
                      k: int, metric: str, cand_docs, cand_valid, doc_ok,
                      has_cand: bool, has_ok: bool):
    """The exact scan over a gathered slab, `_chunk` queries at a time;
    `dots_fn(rows, qf)` gives the rows' dot products with the queries."""
    Qf = _normalize(Q.to(torch.float32), metric)
    B, nprobe = rowmap.shape
    C = _chunk(B, nprobe, tile_shape[0], tile_shape[1])
    outs = []
    for c0 in range(0, B, C):
        rm = rowmap[c0:c0 + C].long()
        qf = Qf[c0:c0 + C]
        outs.append(_scan_tiles_batch(
            dots_fn(rm, qf), slab_sq[rm], slab_ids[rm], qf, k, metric,
            cand_docs[c0:c0 + C] if has_cand else None,
            cand_valid[c0:c0 + C] if has_cand else None,
            doc_ok if has_ok else None))
    return (torch.cat([o[0] for o in outs]),
            torch.cat([o[1] for o in outs]))


def _scan_slab(slab_v, slab_sq, slab_ids, rowmap, Q, k: int, metric: str,
               cand_docs, cand_valid, doc_ok, has_cand: bool,
               has_ok: bool):
    """The exact scan over a gathered f32 slab: rowmap [B, nprobe]
    indexes each query's lists within the slab."""
    return _scan_slab_chunks(lambda rm, qf: _tile_dots(slab_v[rm], qf),
                             slab_sq, slab_ids, slab_v.shape[1:], rowmap,
                             Q, k, metric, cand_docs, cand_valid, doc_ok,
                             has_cand, has_ok)


def host_ivf_knn(hivf: HostIVF, Q: np.ndarray, k: int, nprobe: int,
                 doc_ok=None, cand_docs=None, cand_valid=None):
    """KNN over the host tier: probe on the device, gather the probed
    lists' slabs on the host (`HostIVF.gather`), copy them up
    (`HostIVF.upload`), scan them on the device.  Returns host (dists
    [B, k], local_ids [B, k]).

    doc_ok: optional device bool[n_pad] liveness mask (deletes, TTL).
    cand_docs/cand_valid: optional host [B, Wc] sorted candidate windows
    for filtered KNN."""
    B, d = Q.shape
    nprobe = max(1, min(nprobe, hivf.nlist))
    k = max(1, min(k, hivf.nlist * hivf.list_pad))
    dev = hivf.centroids.device
    Qd = torch.as_tensor(np.ascontiguousarray(Q, np.float32), device=dev)
    lists = _probe_lists(hivf.centroids, hivf.cent_sq, Qd, nprobe,
                         hivf.metric).cpu().numpy()
    uniq, inv = np.unique(lists, return_inverse=True)
    slab = hivf.upload(hivf.gather(uniq))
    rowmap = torch.as_tensor(inv.reshape(B, nprobe), device=dev)
    has_cand = cand_docs is not None
    cd = cv = None
    if has_cand:
        cd = torch.as_tensor(np.ascontiguousarray(cand_docs), device=dev)
        cv = (torch.as_tensor(np.ascontiguousarray(cand_valid), device=dev)
              if cand_valid is not None
              else torch.ones(cd.shape, dtype=torch.bool, device=dev))
    if hivf.compression:
        from .lvq import scan_slab_lvq
        dists, ids = scan_slab_lvq(
            slab["v"], slab["off"], slab["scl"], slab["sq"], slab["ids"],
            rowmap, Qd, k, hivf.metric, cd, cv, doc_ok, has_cand,
            doc_ok is not None)
    else:
        dists, ids = _scan_slab(slab["v"], slab["sq"], slab["ids"], rowmap,
                                Qd, k, hivf.metric, cd, cv, doc_ok,
                                has_cand, doc_ok is not None)
    return dists.cpu().numpy(), ids.cpu().numpy()


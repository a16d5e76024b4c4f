"""Drive the torch port's main path once on one CUDA card, and check it.

    python3 chip_smoke.py
    python3 chip_smoke.py --save-groups PATH   # only: save_b1_groups

Phases, each reported on its own lines; any failure raises and the
script exits non-zero:

1. card: no CUDA device is a failure; prints the device, nvidia-smi's
   name and power limit, and the english stemmer in effect.
2. build: compiles `redisearch_tpu_torch/csrc/intersect.cu`,
   `csrc/phrase.cu` and `csrc/groupby.cu` with nvcc for sm_90a (one nvcc
   each, started together) and prints each one's seconds and ptxas'
   register/spill report.
3. kernel vs plain: random posting windows at the serving buckets (pivot
   2048/8192/32768, members up to 131072), the AND/NOT/OPT/OR families,
   tag-aux and dense-tag plans, k = 1/16/64, multi-phase ORs, and
   batches larger than the kernel's grid; the wide route's pivots
   (65,536 and 131,072 lanes: or2, and2 with both slots wide, a NOT
   member, a batch past the grid); score ties across a tile boundary
   of the narrow, mid and wide block shapes (batches of 1,200, 320 and
   16 queries, which pick those shapes), a wide pivot against a
   131,072-lane member range and phases of at most k matches.  Lane for lane
   equal docs, bit-identical scores, equal counts, in top-k mode and,
   where the pivot is within 32,768 lanes, in raw mode (`raw=True`).
   Then the phrase kernel against `phrase_plain`, top-k and
   raw, on random posting and position-key windows (W0/PW 2048..131072,
   T = 2..4, slop 0/1/3, k = 1/16/64, repeated terms, clamped keys, a
   1024 stride, batches larger than its grid): lane for lane equal,
   scores bit-identical.  Then the group-by kernel against
   `groupby_plain` on random
   gid slots at G = 1..65,536 (both of its branches), 0-3 ops, with and
   without sums of squares, batches below and above its grid: counts
   exact, sums exact on integer inputs whose group sums stay below
   2^24, otherwise within 1e-5 of the group's sum of |v|.  Then the
   fused single-query group-by kernel (B4 sums and B5 min/max in one
   pass, `groupby_aggregate_multi`) against its plain version at n =
   1,000 / 65,536 / 1,000,064 rows and G = 1 / 1,001 / 16,384 / 65,536
   (one and two passes, and the global branch), with and without
   min/max, 0 / 1 / 3 operands, a 0-dim constant operand, masked rows,
   empty groups, negative values, -0.0s and NaNs: counts, min and max
   equal (a zero's sign bit too), sums within 1e-5 of the float64
   sums; a second launch gives bit-identical sums wherever the
   histograms are in shared memory; groups of signed zeros read -0.0 /
   +0.0 in IEEE-754 minimum/maximum order.  The one-operand entry
   `groupby_aggregate` against its plain version too.
4. main path: `Client.ft_create` with bench.py's BM25 schema, a 1M-doc
   FTSB-enwiki-shaped corpus (4+20 zipf(1.25) tokens over a 200k vocab,
   seed 0) through `add_documents`, then `ft_search_many` at batch 8192,
   k=10 on bench.py's eight query families (kernel_hit_pct and the
   window share printed).  Every served query must count under the
   executor the router gives it ("kernel", "kernel-wide" for pivots past
   32,768 postings, "phrase-kernel"; none on the window program), and
   the kernels must have launched on both routes; every query of each
   family is recomputed with the plain versions on the card and must
   agree, and every kernel-wide query must equal the window program's
   result for it (as the JAX package serves it); a few and2 counts are checked against numpy set
   intersections of the host-copied postings; single `ix.search()` (the
   general window program) must equal the batch for 64 queries of each
   family.  Then 256 exact and 256
   slop-1 in-order phrases of 2-4 terms cut from the corpus's own token
   runs: each must ride the phrase kernel, match its source doc and
   agree with its plain recomputation, and 16 must equal the in-order
   proximity model over the host-copied tokens.  QPS (sequential
   batches, and bench.py's pipelined loop at depth 2), memory and the
   kernels' times against the plain versions' (the largest and2 group,
   the largest kernel-wide group beside the window program's time for
   the same queries, every phrase group) are printed for information.
5. profile, for information: per family, the host stages of one batch
   and the device's busy share from torch.profiler.
6. aggregate path: on the same 1M-doc index, `Client.ft_aggregate_many`
   with bench.py's FT.AGGREGATE request (2-term match, GROUPBY @grp with
   COUNT/SUM/AVG(@price), SORTBY @s DESC, LIMIT 0 10) at batch 1024 for
   four batches of kernel-eligible requests (the eligible share is
   printed).  Every request must count under "device-tail" and both
   kernels must have launched; every request is recomputed with the
   plain versions on the card (rows, totals, order and values equal);
   16 are checked against a numpy group-by of the host-copied postings
   and columns.  A second shape (COUNT/STDDEV/AVG, SORTBY @grp) takes
   the host finish with sums of squares.  QPS, each kernel's time
   against its plain version's at the bench shapes and one batch's
   host/device split are printed for information.  Then bench.py's
   bench_agg_star request ('*' GROUPBY @grp COUNT/SUM over all 1M rows)
   at batch 64 on the window branch (every request equal to a numpy
   group-by of the host-copied columns), and bench_agg with MIN and MAX
   added at batch 1024 (every request equal to its plain recomputation,
   16 to numpy, 16 single `ft_aggregate` calls to the batch), each with
   its QPS.  In both, each request makes one call of the fused
   single-query group-by, and the kernel launches counted must be those
   its calls' windows need (two a `*` request: the row pass and its
   merge; one or two a MIN/MAX request).  The fused kernel is timed at
   the '*' shape in sums-only mode (B4's row) and min/max mode (B5's
   row) beside its plain version and one library call each, at the
   median and the largest MIN/MAX window, and at a G = 1 '*' window.
   Kernel times are device times (CUDA events behind a device sleep
   that covers the host's enqueue); each is printed beside its bytes
   bound.
6b. cursors and the host pipeline, on the same 1M-doc index: bench.py's
   FT.AGGREGATE request WITHCURSOR COUNT 3 (four requests; the device
   GROUPBY runs materialized) must page exactly the rows of the plain
   `ft_aggregate`, and the fused single-query group-by must have
   launched in the cursor runs; `*` LOAD @price CURSOR 1000 must total
   1,000,000 with at most two stream chunks buffered after the first
   read, five more pages must hold the host-copied price column in
   window order, then FT.CURSOR DEL, after which a read must raise
   CursorNotFound; 16 host-pipeline requests (2-term match, GROUPBY @grp
   with COUNT, SUM, TOLIST and COUNT_DISTINCT of @cat, every fourth
   keyed on the unsortable @cat instead) must equal a Python group-by of
   the host-copied postings and columns, and their COUNT/SUM the device
   path's for the same match (within 1e-5 of the group's sum); the same
   requests at bench.py's batch of 1,024 through `ft_aggregate_many`
   must count 1,024 "host" requests and equal the single calls; a mixed
   `ft_aggregate_many` batch must count 4 "device-tail" and 4 "host"
   requests, each result's rows equal to its single call's (the device
   tail's SUM/AVG within 1e-5 of the group's sum, all else exact).
   Then a second `*` LOAD @price CURSOR 1000 is drained, all 1,000
   pages, each price equal to the column.  The drain's pages per second
   and the batch's host-pipeline requests per second are printed.
7. vector path (FLAT search; no Pallas kernel lies on it, so its ops
   are torch ops: a GEMM, elementwise masks and `torch.topk`).  First
   bench.py's knn shape at the op level: `ops.vector.knn_scan_batches`
   over 4 chunks of 2048 queries (bench.py scans 48) against 1M x 128
   f32 rows, L2, the bf16 scan copy, k = 10: recall@10 of 256 queries
   against exact float64 distances on the card must reach 0.99, and
   every returned distance must be within 1e-4 relative of its float64
   value; the device time of each part of one chunk (GEMM, epilogue,
   mask, candidate top-C, f32 rescore, final top-k) is printed beside
   its bound.  Then bench.py's filtered-KNN corpus end to end: 500k docs
   x 384-dim unit vectors, COSINE, title 3 of 10 words, year NUMERIC
   sortable, cat TAG, seed 0, through `Client.ft_create` and
   `add_documents`; its fulltext, numeric and tag families, pure KNN and
   a check-only narrow family (text AND one year, HYBRID_POLICY
   ADHOC_BF), batch 2048, KNN 25.  Each family must count under its
   route ("knn-batches", "knn-dense", "knn-dense", "knn-pure",
   "knn-row"); every hit must pass its filter, each distance must be
   within 1e-5 of its float64 value, recall@25 must reach 0.99 against
   an exact float64 top-25 over the filter's docs computed on the card;
   64 single `ft_search` calls must equal the batch; a batch with TF32
   switched on by the caller (an eighth of one for the two families
   that run the window program per query) must give the same results
   and leave the caller's setting as it was.  QPS (one `ft_search_many`
   batch, and `execute_batch` pipelined at depth 2 over 2 batches), peak memory,
   ingest seconds, one batch's device busy and idle share
   (torch.profiler; an eighth of a batch for the two families that run
   the window program per query) and the parts' times at the pure
   family's shape are printed for information.
7b. FT.HYBRID and the rounds API on the 500k x 384 index (bench.py's
   bench_hybrid: single title words, window 20, limit 10, batch 1024,
   seed 5): for RRF and LINEAR, `run_hybrid_many` must equal the
   hit-list fusion `_run_hybrid_hits` for every query (keys and order,
   floats within 1e-6), and route both branches of all 2,048 queries;
   the KNN branch's top-20, as the batch runs it, must reach recall
   0.99 against an exact float64 top-20 on the card; `run_hybrid_rounds`
   over 4 rounds must equal 4 `run_hybrid_many` calls, and
   `execute_batch_rounds` over 4 rounds of bench.py's fknn numeric and
   tag families (batch 2048, KNN 25) 4 sequential `execute_batch` calls,
   idx and distances bit for bit.  Printed for information: each
   branch's routes and time (launch + synchronize per executor group),
   one batch's prepare, bind, d2h, fusion and row times, a traced eighth
   of a batch's device busy and idle share, hybrid QPS (bench.py's loop
   at depth 2, 4 rounds, one pass) and the rounds QPS.
8. ANN (no Pallas kernel lies on it: `ops/ivf.py` and `ops/lvq.py` are
   torch ops), bench.py's bench_ann shape, not cut: 1M x 100 clustered
   COSINE vectors, 256 queries x 4 reps (seed 7), k 10, nlist 1024.  At
   the op level the exact FLAT scan and `ivf_probe_batch` at nprobe
   8/32/128, each with recall@10 against an exact float64 top-10 on the
   card (FLAT at least 0.999, IVF at nprobe 128 at least 0.95), QPS and
   peak transient memory; the host tier built on the IVF's centroids
   must return the IVF's ids at every nprobe.  Then one index with the
   corpus in three fields (IVF on the card, the host tier in f32, LVQ8)
   through `Client.ft_create` and `add_documents`: `ft_search_many` at
   each nprobe (EF_RUNTIME) on each field, routed "window" (IVF) or
   "knn-host" (the host tier), with recall@10 (IVF and the host tier at
   least 0.95 at nprobe 128; LVQ8 at least 0.95 against its
   reconstructions' own float64 top-10, its scans being exact against
   them, and tests/test_lvq.py's recall-parity case, 0.97 of the f32
   tier's ids, on the card), 8 single `ft_search` calls equal to the
   batch, QPS, a traced
   batch's idle share, and each part's device time beside its bound
   (probe product, tile gather, scan product, distance + top-k; the host
   tier's slab gather on the host clock and its copy to the card).
9. GEO: 1M docs with one point each (uniform over a 50 km box), a TEXT
   and a TAG field (seed 11), through `add_documents`; radius queries
   of 1-20 km alone, AND a term and AND a TAG, batched at 1024 (each
   routed "window") and 64 single calls each equal to the batch; every
   query is held against a float64 haversine on the card over the f32
   radians the index holds (totals equal but for docs within 1e-6
   relative of the radius, hits inside the radius and passing the
   filter, the lowest matching docs where every match scores alike).
10. cold: the main path's 1M-doc corpus as a `storage="host"` index
   (its CSR arrays on the host); bench.py's eight families, 256 queries
   each, through `ft_search_many` (routed "cold"), each equal to the
   hot index's result for the same query (`same_hits`); the device
   memory the cold index adds must not exceed its dense columns.  QPS,
   the host's bind + slab paging time a query, and a traced batch's
   idle share are printed.
11. lifecycle, on the main path's 1M-doc index (run last: it deletes
   from it).  (a) `save_index` of the clean index (its parts timed,
   and its arrays written once more with compressed members, as the JAX
   package writes them), `load_index` of it under a
   second name: the eight families at batch 8192 take the original's
   routes (kernel_hit_pct as before), B1 and B2 launch, and every result
   equals the original's, scores bit for bit; `ft_dropindex` of it, with
   the device memory before and after.  (b) `Client.hdel` of 200,000
   keys (i % 5 == 1; deletes a second printed): `maybe_compact` keeps
   the segment (20% < 25%), 256 queries a family ride the window program
   and serve no deleted key, 16 and2 totals equal numpy set
   intersections over the live docs, 64 of bench.py's FT.AGGREGATE
   requests equal a numpy group-by over the live docs (COUNT exact,
   SUM within 1e-5 of the group's sum).  (c) `ft_del` of 60,000 more
   (26%): `maybe_compact` compacts through the slice path into one
   segment of 740,000 docs and no deletes (seconds split into
   `live_locals`, slice and upload; peak transient device memory).
   (d) the compacted index: the eight families at batch 8192 with no
   window query, each equal to its plain recomputation on the card;
   256 phrases cut from live docs on B2, each matching its doc;
   bench.py's aggregate at batch 1024 on the device tail, equal to
   plain; `*` GROUPBY @grp COUNT summing to 740,000 (B4 launched); the
   launch counters zeroed just before this run and read just after.
   (e) a rebuild of the 740,000 live docs in corpus order through
   `add_documents` (ingest seconds beside the compaction's): every
   query of the eight families equal to the compacted index's
   (`same_hits`).  (f) `hset` of 1,000 live keys with new text and of
   1,000 new keys, one query seals the second segment: 256 queries a
   family find each new doc by its own tokens, no overwritten version is
   served (256 and2 totals equal numpy over the live docs, 256 title
   phrases), `ft_get` and `ft_mget` return the new fields.  QPS on the
   dirty and the compacted index are printed.
12. the module check (no jax, no module file under `redisearch_tpu/`),
   then the last three lines: nvidia-smi's name and power limit, the
   kernels' JSON record, then {"ok": true, "device": {...}}.

Phase 6 also runs `APPLY "1+2" AS k GROUPBY @k REDUCE COUNT 0` (a key
column from constants only) through `ft_aggregate_many` and
`ft_aggregate`: device path, key column on the card, one group of every
document.  To run phases 8-11 alone: import `chip_smoke`, then
`phase_ann(dev)`, `phase_geo(dev)`, and `main = phase_main_path(dev,
N_DOCS, BATCH)` before `phase_cold(dev, main)` and
`phase_lifecycle(dev, main)`.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

import redisearch_tpu_torch as rt
from redisearch_tpu_torch.agg import pipeline as AP
from redisearch_tpu_torch.ops import _build
from redisearch_tpu_torch.ops import groupby as GB
from redisearch_tpu_torch.ops import intersect as IK
from redisearch_tpu_torch.ops import lvq as TL
from redisearch_tpu_torch.ops import text as T
from redisearch_tpu_torch.ops import vector as V
from redisearch_tpu_torch.query import engine as E

N_DOCS = 1_000_000
BATCH = 8192
K = 10
SCORE_RTOL = 1e-6
KERNEL_SRC = "redisearch_tpu_torch/csrc/intersect.cu"
KERNEL_REPLACES = "redisearch_tpu/ops/intersect.py:295"
PHRASE_SRC = "redisearch_tpu_torch/csrc/phrase.cu"
PHRASE_REPLACES = "redisearch_tpu/ops/intersect.py:854"
GB_SRC = "redisearch_tpu_torch/csrc/groupby.cu"
GB_REPLACES = "redisearch_tpu/ops/groupby.py:161"
SUMS_REPLACES = "redisearch_tpu/ops/groupby.py:43"
MINMAX_REPLACES = "redisearch_tpu/ops/groupby.py:87"
#: the card's memory rate (H100 SXM data sheet), for the bytes bound
HBM_BYTES_PER_S = 3.35e12
STAR_BATCH = 64
AGG_BATCH = 1024
AGG_BATCHES = 4

# bench.py's eight families: phrase rides the phrase kernel, the other
# seven the intersection kernel
FAMILIES = {
    "and2": lambda qt, i: f"{qt[(2*i) % 500]} {qt[(2*i+1) % 500]}",
    "phrase": lambda qt, i: f'"{qt[(2*i) % 500]} {qt[(2*i+1) % 500]}"',
    "and2_tag": lambda qt, i: (f"{qt[(2*i) % 500]} {qt[(2*i+1) % 500]} "
                               f"@cat:{{cat{i % 16:02d}}}"),
    "and3": lambda qt, i: (f"{qt[(3*i) % 500]} {qt[(3*i+1) % 500]} "
                           f"{qt[(3*i+2) % 500]}"),
    "or2": lambda qt, i: f"{qt[(2*i) % 500]}|{qt[(2*i+1) % 500]}",
    "not2": lambda qt, i: f"{qt[(2*i) % 500]} -{qt[(2*i+1) % 500]}",
    "opt2": lambda qt, i: f"{qt[(2*i) % 500]} ~{qt[(2*i+1) % 500]}",
    "fields2": lambda qt, i: (f"@title:{qt[(2*i) % 500]} "
                              f"@body:{qt[(2*i+1) % 500]}"),
}


_T0 = time.perf_counter()


def log(*a):
    """A line of the report; phase lines carry the seconds since start."""
    msg = " ".join(str(x) for x in a)
    if msg.startswith("phase "):
        msg = f"[{time.perf_counter() - _T0:7.1f}s] {msg}"
    print(msg, flush=True)


# ---------------------------------------------------------------- phase 1
def phase_card() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("phase card: FAILED — torch.cuda.is_available() "
                         "is false")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True
    ).stdout.strip().splitlines()[0]
    log(f"phase card: {name}, device_count={torch.cuda.device_count()}, "
        f"torch {torch.__version__}, cuda {torch.version.cuda}")
    log(f"phase card: nvidia-smi: {smi}")
    log(f"phase card: stemmer in effect for english: {stemmer_in_effect()}")
    return smi


def stemmer_in_effect() -> str:
    """Which english stemmer the analysis uses on this machine: Snowball
    english where nltk is installed, else the Porter (1980) fallback,
    whose stems (and so `+stem` expansions) can differ."""
    from redisearch_tpu_torch.analysis import stemmer as S
    if S.Stemmer("english")._fn is S.porter_stem:
        return "Porter-1980 fallback (no nltk: not Snowball english)"
    return "Snowball english (nltk)"


# ---------------------------------------------------------------- phase 2
def phase_build():
    t0 = time.perf_counter()
    _build.build_all()
    log(f"phase build: {len(_build.SRCS)} libraries in "
        f"{time.perf_counter() - t0:.2f}s (one nvcc per source, in "
        f"parallel)")
    built = {name: dict(info) for name, info in _build.BUILD_INFO.items()}
    for name in _build.SRCS:
        _build.load(name)
        info = built[name]
        log(f"phase build: {name}: {info['path']} built={info['built']} "
            f"seconds={info['seconds']:.2f}")
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"phase build: {name}: ptxas: {line.strip()}")


# ---------------------------------------------------------------- phase 3
def make_windows(rng, B, Ws, n_docs=2_000_000, overlap=0.5, full=False):
    """Random doc-sorted posting windows sharing a per-query doc pool (so
    slots genuinely intersect), at arbitrary offsets of flat arrays —
    the layout of tests/test_pallas_interpret.py's _make_windows.  Each
    window's live length is drawn from [W/2, W], or is W with `full`."""
    T = len(Ws)
    total = B * sum(w + 128 for w in Ws) + 4096
    doc_ids = np.full(total, 2**31 - 1, np.int32)
    freqs = np.zeros(total, np.float32)
    masks = np.zeros(total, np.int32)
    dl = (np.abs(rng.normal(24.0, 6.0, total)) + 1.0).astype(np.float32)
    meta = np.zeros((B, 3 * T), np.int32)
    fmeta = np.zeros((B, T + 1), np.float32)
    at = 0
    for b in range(B):
        pool = np.unique(rng.integers(0, n_docs, 2 * max(Ws)))
        for t, W in enumerate(Ws):
            live = W if full else int(rng.integers(max(1, W // 2), W + 1))
            shared = pool[rng.random(len(pool)) < overlap][:live]
            extra = rng.integers(0, n_docs, live)
            docs = np.unique(np.concatenate([shared, extra]))[:live]
            live = len(docs)
            doc_ids[at:at + live] = docs
            freqs[at:at + live] = rng.integers(1, 8, live)
            masks[at:at + live] = np.where(rng.random(live) < 0.9, 3, 4)
            meta[b, t], meta[b, T + t], meta[b, 2 * T + t] = at, live, 3
            at += W + int(rng.integers(0, 128))
        fmeta[b, :T] = rng.uniform(0.5, 4.0, T)
        fmeta[b, T] = 24.0
    return meta, fmeta, doc_ids, freqs, masks, dl


def kernel_cases(rng, B=48):
    """(label, numpy args, plan kwargs) at the serving buckets, B queries
    each."""
    R, N, O = IK.REQ, IK.NOT, IK.OPT
    plain = [
        ("and2", (2048, 8192), ((R, (0,)), (R, (1,))), 16),
        ("and2-k1", (2048, 8192), ((R, (0,)), (R, (1,))), 1),
        ("and2-k64", (8192, 32768), ((R, (0,)), (R, (1,))), 64),
        ("not", (2048, 32768), ((R, (0,)), (N, (1,))), 16),
        ("opt", (8192, 2048), ((R, (0,)), (O, (1,))), 16),
        ("or2", (2048, 2048), ((R, (0, 1)),), 16),
        ("and2not-member131072", (2048, 8192, 131072),
         ((R, (0,)), (R, (1,)), (N, (2,))), 16),
        ("pivot32768", (32768, 131072), ((R, (0,)), (R, (1,))), 16),
        ("or3-3phase", (2048, 2048, 8192), ((R, (0, 1, 2)),), 16),
        ("or2-and-not", (2048, 2048, 8192, 8192),
         ((R, (0, 1)), (R, (2,)), (N, (3,))), 64),
    ]
    out = []
    for label, Ws, groups, k in plain:
        args = make_windows(rng, B, Ws)
        out.append((label, args, dict(T=len(Ws), Ws=Ws, groups=groups,
                                      k=k)))
    # more queries than the kernel's grid: blocks serve q, q + grid, ...
    # and reuse their scratch row and shared state
    B_big = IK._MAX_GRID + 517
    for label, Ws, groups in (
            ("and2-gridstride", (2048, 2048), ((R, (0,)), (R, (1,)))),
            ("or2-gridstride", (2048, 2048), ((R, (0, 1)),))):
        args = make_windows(rng, B_big, Ws)
        out.append((label, args, dict(T=2, Ws=Ws, groups=groups, k=16)))
    # TAG member slots streamed from an aux doc-window array
    Ws = (2048, 8192)
    meta, fmeta, d, f, m, dl = make_windows(rng, B, Ws)
    aux = np.full(B * 8193 + 4096, 2**31 - 1, np.int32)
    at = 0
    for b in range(B):
        live = int(rng.integers(4096, 8193))
        docs = np.unique(rng.integers(0, 2_000_000, live))
        aux[at:at + len(docs)] = docs
        meta[b, 1], meta[b, 3] = at, len(docs)
        at += 8192 + 1
    out.append(("tag-aux", (meta, fmeta, d, f, m, dl, aux),
                dict(T=2, Ws=Ws, groups=((R, (0,), -1), (R, (1,), 0)),
                     k=16)))
    # dense posting-aligned code predicates (REQ with 2 values, NOT)
    meta, fmeta, d, f, m, dl = make_windows(rng, B, Ws)
    codes = rng.integers(0, 8, d.shape[0]).astype(np.int32)
    q = rng.integers(-1, 10, (B, 3)).astype(np.int32)
    q[rng.random(B) < 0.3, 1] = -2          # unbound value slots
    meta = np.concatenate([meta, q], axis=1)
    fmeta = np.concatenate(
        [fmeta, rng.uniform(0.5, 4.0, (B, 2)).astype(np.float32)], 1)
    out.append(("dense-tag", (meta, fmeta, d, f, m, dl, codes),
                dict(T=2, Ws=Ws, groups=((R, (0,), -1), (R, (1,), -1)),
                     k=16, dense=((R, 0, 2), (N, 0, 1)))))
    return out + wide_kernel_cases(rng) + tile_kernel_cases(rng)


def wide_kernel_cases(rng):
    """The wide route's shapes: pivots past MAX_W_PIVOT (top-k mode
    only), up to MAX_W_MEMBER, at k = 16 and 64, and a batch past the
    grid (8 distinct queries repeated)."""
    R, N = IK.REQ, IK.NOT
    out = []
    for label, Ws, groups, k, B in (
            ("wide-or2-65536x2048", (65536, 2048), ((R, (0, 1)),), 16, 16),
            ("wide-or2-131072x131072", (131072, 131072), ((R, (0, 1)),),
             64, 8),
            ("wide-and2-both", (131072, 65536), ((R, (0,)), (R, (1,))), 16,
             8),
            ("wide-not", (65536, 131072), ((R, (0,)), (N, (1,))), 64, 8)):
        out.append((label, make_windows(rng, B, Ws),
                    dict(T=2, Ws=Ws, groups=groups, k=k)))
    Ws = (65536, 2048)
    args = make_windows(rng, 8, Ws)
    pick = rng.integers(0, 8, IK._MAX_GRID + 517)
    out.append(("wide-or2-gridstride", (args[0][pick], args[1][pick])
                + args[2:], dict(T=2, Ws=Ws, groups=((R, (0, 1)),), k=16)))
    return out


def with_tie_band(args, lo, hi):
    """Every query's pivot (slot 0) lanes [lo, hi) get one score (tf 7,
    doc length 24, mask-valid; the other lanes tf 1), above every other
    lane: a tie that straddles a tile boundary inside [lo, hi)."""
    meta, fmeta, d, f, m, dl = (a.copy() for a in args)
    T = meta.shape[1] // 3
    for b in range(meta.shape[0]):
        s_, n = int(meta[b, 0]), int(meta[b, T])
        if n < hi:
            raise AssertionError("tie band past the live lanes")
        f[s_:s_ + n] = 1.0
        f[s_ + lo:s_ + hi] = 7.0
        dl[s_ + lo:s_ + hi] = 24.0
        m[s_ + lo:s_ + hi] = 3
    return meta, fmeta, d, f, m, dl


def tile_kernel_cases(rng):
    """Cases aimed at the kernel's tiles and top-k paths, in the wide
    block shape (16 queries or fewer): a tie across its 2,048-lane tile
    boundary (the running top-k full before it at k = 16, not at k = 64),
    a wide pivot against a 131,072-lane member range, and phases of at
    most k matches (some empty)."""
    R, N, O = IK.REQ, IK.NOT, IK.OPT
    out = []
    for label, Ws, groups, k, B in (
            ("tile-tie-not-k16", (4096, 2048), ((R, (0,)), (N, (1,))), 16,
             16),
            ("tile-tie-not-k64", (4096, 2048), ((R, (0,)), (N, (1,))), 64,
             16),
            ("tile-tie-or2-k16", (4096, 2048), ((R, (0, 1)),), 16, 16),
            ("wide-tile-tie-not-k16", (65536, 2048), ((R, (0,)), (N, (1,))),
             16, 8)):
        args = with_tie_band(make_windows(rng, B, Ws, full=True), 2030,
                             2070)
        out.append((label, args, dict(T=2, Ws=Ws, groups=groups, k=k)))
    Ws = (65536, 131072)
    out.append(("wide-member-131072", make_windows(rng, 8, Ws,
                                                       full=True),
                dict(T=2, Ws=Ws, groups=((R, (0,)), (R, (1,))), k=16)))
    Ws = (8192, 2048)
    meta, *rest = make_windows(rng, 48, Ws)
    meta = meta.copy()
    meta[:, 2] = rng.integers(0, 40, 48)          # pivot lens, some 0
    out.append(("count-le-k", (meta, *rest),
                dict(T=2, Ws=Ws, groups=((R, (0,)), (O, (1,))), k=64)))
    return out + shape_kernel_cases(rng)


def shape_kernel_cases(rng):
    """Batches for the narrow and mid block shapes (the kernel picks its
    shape from the pivot bucket and the batch; the cases above mostly take
    the mid and wide ones): narrow, 1,200 queries with 2,048-lane pivots
    (at least 8 an SM of an H100's 132); mid, 320 queries with pivots of
    4,096-32,768 lanes (at least 2 an SM).  OR, NOT and OPT members, k =
    16 and 64, ties across a tile boundary (lane 256 of the narrow shape's
    tiles, lane 2,048 of the mid's), phases of at most k matches."""
    R, N, O = IK.REQ, IK.NOT, IK.OPT
    out = []
    Ws = (2048, 2048)
    for label, groups, k in (
            ("narrow-tile-tie-not-k16", ((R, (0,)), (N, (1,))), 16),
            ("narrow-tile-tie-or2-k64", ((R, (0, 1)),), 64)):
        args = with_tie_band(make_windows(rng, 1200, Ws, full=True), 240,
                             270)
        out.append((label, args, dict(T=2, Ws=Ws, groups=groups, k=k)))
    meta, *rest = make_windows(rng, 1200, Ws)
    meta = meta.copy()
    meta[:, 2] = rng.integers(0, 40, 1200)        # pivot lens, some 0
    out.append(("narrow-count-le-k", (meta, *rest),
                dict(T=2, Ws=Ws, groups=((R, (0,)), (O, (1,))), k=64)))
    for label, Ws, groups, k in (
            ("mid-or2-8192x2048", (8192, 2048), ((R, (0, 1)),), 16),
            ("mid-not-32768x2048", (32768, 2048), ((R, (0,)), (N, (1,))),
             64),
            ("mid-opt-8192x8192", (8192, 8192), ((R, (0,)), (O, (1,))), 16)):
        out.append((label, make_windows(rng, 320, Ws),
                    dict(T=2, Ws=Ws, groups=groups, k=k)))
    Ws = (4096, 2048)
    args = with_tie_band(make_windows(rng, 320, Ws, full=True), 2030, 2070)
    out.append(("mid-tile-tie-not-k16", args,
                dict(T=2, Ws=Ws, groups=((R, (0,)), (N, (1,))), k=16)))
    return out


def compare_raw(kout, pout, what):
    """Kernel vs plain, lane for lane (raw mode, and the phrase kernel's
    top-k lanes): equal docs, bit-identical scores, equal counts.
    Returns the max abs score difference (0)."""
    kd, ks, kc = (t.cpu().numpy() for t in kout)
    pd, ps, pc = (t.cpu().numpy() for t in pout)
    if kd.shape != pd.shape or ks.shape != ps.shape:
        raise AssertionError(f"{what}: shapes {kd.shape} vs {pd.shape}")
    if not np.array_equal(kc, pc):
        raise AssertionError(f"{what}: counts differ at "
                             f"{np.flatnonzero(kc != pc)[:5]}")
    if not np.array_equal(kd, pd):
        bad = np.argwhere(kd != pd)[:5]
        raise AssertionError(f"{what}: docs differ at {bad.tolist()}")
    if not np.array_equal(ks.view(np.int32), ps.view(np.int32)):
        bad = np.argwhere(ks.view(np.int32) != ps.view(np.int32))[:5]
        raise AssertionError(f"{what}: scores not bit-identical at "
                             f"{bad.tolist()}")
    return float(np.abs(ks - ps).max()) if ks.size else 0.0


def phase_kernel_vs_plain(dev, B: int = 48) -> tuple:
    """Top-k and raw mode of every case (raw where the pivot is within
    MAX_W_PIVOT), lane for lane with bit-identical scores; returns the
    two max errors (0)."""
    rng = np.random.default_rng(7)
    err, err_raw = 0.0, 0.0
    for label, args, kw in kernel_cases(rng, B):
        t = [torch.as_tensor(a, device=dev) for a in args]
        kout = IK.intersect_batch(*t, **kw)
        pout = IK.intersect_plain(*t, **kw)
        torch.cuda.synchronize()
        e = compare_raw(kout, pout, f"kernel vs plain [{label}]")
        err = max(err, e)
        n_hit = int((pout[1] > -3.3e38).sum())
        log(f"phase kernel-vs-plain: {label} Ws={kw['Ws']} k={kw['k']} "
            f"B={args[0].shape[0]} live lanes={n_hit} "
            f"matches={int(pout[2].sum())} lane for lane equal, scores "
            f"bit-identical")
        if not n_hit:
            raise AssertionError(f"kernel vs plain [{label}]: no matches")
        del kout, pout
        piv = kw["groups"][kw.get("pivot_g", 0)][1]
        if max(kw["Ws"][p] for p in piv) > IK.MAX_W_PIVOT:
            del t
            continue
        kout = IK.intersect_batch(*t, raw=True, **kw)
        pout = IK.intersect_plain(*t, raw=True, **kw)
        torch.cuda.synchronize()
        e = compare_raw(kout, pout, f"raw kernel vs plain [{label}]")
        err_raw = max(err_raw, e)
        log(f"phase kernel-vs-plain: raw {label} lanes/query="
            f"{kout[0].shape[1]} B={args[0].shape[0]} "
            f"matches={int(pout[2].sum())} lane for lane equal, scores "
            f"bit-identical")
        del kout, pout, t
    torch.cuda.synchronize()
    return err, err_raw


def make_phrase_windows(rng, B, Ws, PWs, stride=64, n_docs=2_000_000,
                        clamp=False, repeat=False):
    """Random phrase inputs (tests/test_torch_phrase.py's _make_phrase,
    vectorised): per query and slot a doc-sorted posting window and a
    sorted position-key window (doc * stride + pos, 1-2 random positions
    a doc) at arbitrary offsets of flat arrays, INT32_MAX past the live
    length.  Half the docs common to every slot get an in-order run with
    gaps of 0-2 positions, so chains of every slop match.  clamp:
    positions past stride - 1 are clamped there (keys repeat within a
    term, as on a pos_clamped segment).  repeat: slot 1 reads slot 0's
    windows (a repeated term).  Keys past PW are cut."""
    T = len(Ws)
    # each window takes at most its bucket + 255 (offset and gap), and
    # the last one's bucket stays inside the array: no start is clamped
    n_post = B * sum(w + 256 for w in Ws) + max(Ws) + 4096
    n_keys = B * sum(p + 256 for p in PWs) + max(PWs) + 4096
    doc_ids = np.full(n_post, 2**31 - 1, np.int32)
    freqs = np.zeros(n_post, np.float32)
    masks = np.zeros(n_post, np.int32)
    dl = (np.abs(rng.normal(24.0, 6.0, n_post)) + 1.0).astype(np.float32)
    keys = np.full(n_keys, 2**31 - 1, np.int32)
    meta = np.zeros((B, 5 * T), np.int32)
    fmeta = np.zeros((B, T + 1), np.float32)
    at_p = at_k = 0
    for b in range(B):
        pool = np.unique(rng.integers(0, n_docs, max(Ws)))
        slot_docs = []
        for W in Ws:
            live = int(rng.integers(max(1, W // 4), W + 1))
            shared = pool[rng.random(len(pool)) < 0.6]
            extra = rng.integers(0, n_docs, live)
            slot_docs.append(np.unique(np.concatenate([shared, extra]))[:live])
        common = slot_docs[0]
        for d in slot_docs[1:]:
            common = np.intersect1d(common, d)
        seeded = common[rng.random(len(common)) < 0.5]
        p0 = rng.integers(0, stride - 3 * T, len(seeded))
        gaps = np.cumsum(rng.integers(0, 3, (len(seeded), T)), axis=1)
        for t, W in enumerate(Ws):
            if repeat and t == 1:
                meta[b, 1::T] = meta[b, 0::T]
                continue
            docs = slot_docs[t]
            at_p += int(rng.integers(0, 128))
            live = len(docs)
            doc_ids[at_p:at_p + live] = docs
            freqs[at_p:at_p + live] = rng.integers(1, 8, live)
            masks[at_p:at_p + live] = np.where(rng.random(live) < 0.9, 3, 4)
            dd = np.repeat(docs, rng.integers(1, 3, live)).astype(np.int64)
            hi = stride + 40 if clamp else stride
            pos = rng.integers(0, hi, dd.size)
            dd = np.concatenate([dd, seeded])
            pos = np.concatenate([pos, p0 + t + gaps[:, t]])
            ks = dd * stride + np.minimum(pos, stride - 1)
            ks = np.sort(ks) if clamp else np.unique(ks)
            n_live = min(len(ks), PWs[t])
            at_k += int(rng.integers(0, 128))
            keys[at_k:at_k + n_live] = ks[:n_live]
            meta[b, t], meta[b, T + t], meta[b, 2 * T + t] = at_p, live, 3
            meta[b, 3 * T + t], meta[b, 4 * T + t] = at_k, n_live
            at_p += W + 128
            at_k += PWs[t] + 128
        fmeta[b, :T] = rng.uniform(0.5, 4.0, T)
        if repeat:
            fmeta[b, 1] = fmeta[b, 0]
        fmeta[b, T] = 24.0
    return meta, fmeta, doc_ids, freqs, masks, dl, keys


# (label, Ws, PWs, slop, k, layout, stride, distinct queries, batch):
# W0 / PW at the serving buckets 2048..131072, T = 2..4, slop 0/1/3,
# k = 1/16/64; a batch above a distinct count repeats those queries, so
# that it outgrows the kernel's grid (4096 blocks; 512 at W0 = 131072)
PHRASE_CASES = [
    ("t2-exact", (2048, 2048), (4096, 4096), 0, 16, None, 64, 48, 48),
    ("t2-slop1-k1", (2048, 8192), (4096, 16384), 1, 1, None, 64, 48, 48),
    ("t3-slop3", (8192,) * 3, (16384,) * 3, 3, 16, None, 64, 32, 32),
    ("t4-exact-k64", (2048, 2048, 8192, 2048), (4096, 4096, 16384, 4096),
     0, 64, None, 64, 48, 48),
    ("t2-slop1-32768", (32768, 32768), (65536, 65536), 1, 16, None, 64,
     16, 16),
    ("t3-131072-k64", (131072, 32768, 32768), (131072, 65536, 65536), 0,
     64, None, 64, 8, 8),
    ("t2-131072-slop3", (32768, 131072), (131072, 131072), 3, 16, None,
     64, 8, 8),
    ("t2-repeated", (2048, 2048), (4096, 4096), 0, 16, "repeat", 64, 48,
     48),
    ("t2-clamped", (2048, 2048), (4096, 4096), 0, 16, "clamp", 64, 48, 48),
    ("t3-clamped-slop1", (8192,) * 3, (16384,) * 3, 1, 16, "clamp", 64,
     32, 32),
    ("t2-stride1024", (2048, 2048), (4096, 4096), 1, 16, None, 1024, 48,
     48),
    ("t2-gridstride", (2048, 2048), (4096, 4096), 1, 16, None, 64, 48,
     IK._MAX_GRID + 517),
    ("t2-131072-gridstride", (131072, 2048), (131072, 4096), 0, 16, None,
     64, 8, 600),
]


def phrase_case_args(rng, case):
    label, Ws, PWs, slop, k, layout, stride, n_q, B = case
    n_docs = min(2_000_000, (2**31 - 1) // stride - 1)
    args = make_phrase_windows(rng, n_q, Ws, PWs, stride=stride,
                               n_docs=n_docs, clamp=layout == "clamp",
                               repeat=layout == "repeat")
    if B > n_q:
        pick = rng.integers(0, n_q, B)
        args = (args[0][pick], args[1][pick]) + args[2:]
    return args, dict(T=len(Ws), Ws=Ws, PWs=PWs, stride=stride, slop=slop,
                      k=k)


def phase_phrase_vs_plain(dev) -> float:
    """The phrase kernel against `phrase_plain` on every PHRASE_CASES
    case, top-k and raw: docs and counts equal, scores bit-identical,
    lane for lane.  Returns the max abs score difference (0)."""
    rng = np.random.default_rng(13)
    err = 0.0
    for case in PHRASE_CASES:
        args, kw = phrase_case_args(rng, case)
        t = [torch.as_tensor(a, device=dev) for a in args]
        for raw in (False, True):
            kout = IK.phrase_batch(*t, raw=raw, **kw)
            pout = IK.phrase_plain(*t, raw=raw, **kw)
            torch.cuda.synchronize()
            what = f"phrase kernel vs plain [{case[0]} raw={raw}]"
            err = max(err, compare_raw(kout, pout, what))
            log(f"phase phrase-vs-plain: {case[0]} raw={raw} Ws={kw['Ws']} "
                f"PWs={kw['PWs']} slop={kw['slop']} k={kw['k']} "
                f"stride={kw['stride']} B={args[0].shape[0]} lanes/query="
                f"{kout[0].shape[1]} matches={int(pout[2].sum())} lane "
                f"for lane equal, scores bit-identical")
            if int(pout[2].sum()) == 0:
                raise AssertionError(f"{what}: no phrase matches generated")
            del kout, pout
        del t
    torch.cuda.synchronize()
    return err


# (G, n_ops, want_sumsq, n, B, integer values)
GB_CASES = [
    (1, 0, False, 33792, 64, True),
    (7, 1, True, 9216, 256, True),
    (1001, 1, False, 9216, 1024, True),        # the bench shape
    (1001, 3, True, 33792, 64, False),
    (4000, 1, True, 9216, 128, False),         # 64 KB: opted-in smem
    (12000, 1, True, 9216, 64, True),          # 192 KB of shared memory
    (65536, 1, True, 33792, 32, True),         # global-atomics branch
    (65536, 0, False, 9216, 16, False),        # global-atomics branch
    (1001, 1, True, 512, GB._MAX_GRID + 517, True),    # grid stride
    (7, 3, False, 2048, GB._MAX_GRID + 517, False),    # grid stride
]


def compare_groupby(kres, pres, scale, integer, what) -> float:
    """Counts exact; sums exact where integer inputs keep the group's
    sum of |v| (of v*v) below 2^24, else within 1e-5 of it."""
    err = 0.0
    if sorted(kres) != sorted(pres):
        raise AssertionError(f"{what}: keys {sorted(kres)}")
    for key in pres:
        k = kres[key].cpu().numpy()
        p = pres[key].cpu().numpy()
        if key.endswith(".count"):
            if not np.array_equal(k, p):
                raise AssertionError(f"{what}: {key} differs")
            continue
        sc = scale[key].cpu().numpy()
        d = np.abs(k.astype(np.float64) - p)
        exact = (sc < 2 ** 24) if integer else np.zeros_like(d, bool)
        if (d[exact] != 0).any() or (d > 1e-5 * sc).any():
            i = np.unravel_index(np.argmax(d - 1e-5 * sc), d.shape)
            raise AssertionError(f"{what}: {key} {k[i]} vs {p[i]} (scale "
                                 f"{sc[i]})")
        err = max(err, float(d.max()) if d.size else 0.0)
    return err


def phase_groupby_vs_plain(dev) -> float:
    rng = np.random.default_rng(11)
    err = 0.0
    for G, n_ops, sq, n, B, integer in GB_CASES:
        S = 1 + n_ops
        gs = rng.integers(0, G, (B, S, n), dtype=np.int32)
        gs[rng.random((B, S, n)) < 0.3] = -1
        vs = (rng.integers(1, 10_000, (B, n_ops, n)) if integer
              else rng.normal(0.0, 1000.0, (B, n_ops, n))).astype(np.float32)
        gs_t = torch.as_tensor(gs, device=dev)
        vs_t = torch.as_tensor(vs, device=dev)
        kres = GB.groupby_aggregate_batch(gs_t, vs_t, G, want_sumsq=sq)
        pres = GB.groupby_plain(gs_t, vs_t, G, want_sumsq=sq)
        scale = GB.groupby_plain(gs_t, vs_t.abs(), G, want_sumsq=sq)
        torch.cuda.synchronize()
        what = f"groupby kernel vs plain [G={G} ops={n_ops} sumsq={sq}]"
        e = compare_groupby(kres, pres, scale, integer, what)
        err = max(err, e)
        smem = GB._channels(S, sq) * GB._g_pad(G) * 4
        log(f"phase groupby-vs-plain: G={G} n_ops={n_ops} sumsq={sq} n={n} "
            f"B={B} {'integer' if integer else 'normal'} values, "
            f"{'shared' if smem <= GB.SMEM_MAX else 'global'} branch "
            f"({smem} B/query), rows={int(pres['g.None.count'].sum())} "
            f"max_abs_err={e:.3g} ok")
        del gs_t, vs_t, kres, pres, scale
    torch.cuda.synchronize()
    return err


# (n, G, integer values): n in {1,000; 65,536; a 1M-doc segment's n_pad},
# G in {1; 1,001; 16,384 and 65,536 (the global branch)}; each with one
# operand, with and without min/max
N_PAD_1M = 1_000_064
GB1_CASES = [(n, G, (i + j) % 2 == 0)
             for i, n in enumerate((1000, 65536, N_PAD_1M))
             for j, G in enumerate((1, 1001, 16384, 65536))]
# (n, G, n_ops, last operand a 0-dim constant, integer values); 17
# operands take two launches (16 a launch)
GB1_OPS_CASES = [(1000, 7, 0, False, True), (65536, 1001, 0, False, False),
                 (3000, 7, 17, True, False),
                 (1000, 7, 3, False, False), (65536, 1001, 3, True, True),
                 (N_PAD_1M, 1001, 3, True, False),
                 (N_PAD_1M, 1, 1, True, True), (9000, 65536, 3, True, False)]


def single_gb_inputs(rng, n, G, integer):
    """Raw group-by inputs: gids with out-of-range ids (-1 and >= G),
    invalid rows, every third group left empty (its rows masked),
    negative values, one in 50 values -0.0; one NaN per 100,000 rows in
    the normal-valued cases."""
    g = rng.integers(-1, G + 2, n).astype(np.int32)
    if G > 2:
        g[(g >= 0) & (g % 3 == 1)] = -1
    valid = rng.random(n) < 0.8
    if integer:
        v = rng.integers(-9999, 10_000, n).astype(np.float32)
    else:
        v = rng.normal(0.0, 1000.0, n).astype(np.float32)
        v[rng.integers(0, n, max(1, n // 100_000))] = np.nan
    v[rng.random(n) < 0.02] = -0.0
    return g, valid, v


def single_gb_operands(rng, dev, n, G, n_ops, const, integer):
    """(gid, valid, [(values, present)]) on the card; with `const` the
    last operand is a 0-dim constant expanded with stride 0, as the
    pipeline's `_lanes` leaves an APPLY constant."""
    g, valid, v = single_gb_inputs(rng, n, G, integer)
    ops = []
    for j in range(n_ops):
        if const and j == n_ops - 1:
            ops.append((torch.tensor(-2.5, device=dev).expand(n),
                        torch.tensor(True, device=dev).expand(n)))
            continue
        vj = v if j == 0 else single_gb_inputs(rng, n, G, integer)[2]
        ops.append((torch.as_tensor(vj, device=dev),
                    torch.as_tensor(rng.random(n) < 0.7, device=dev)))
    return (torch.as_tensor(g, device=dev), torch.as_tensor(valid, device=dev),
            ops)


def f64_sums(g, valid, v, G):
    """count/sum/sumsq/sum|v| per group in float64 on the host: the
    truth the f32 sums are held to."""
    g, valid, v = (t.cpu().numpy() for t in (g, valid, v))
    ok = valid & (g >= 0) & (g < G)
    gg = np.where(ok, g, G)
    vm = np.where(ok, v, 0.0).astype(np.float64)
    return {"sum": np.bincount(gg, vm, G + 1)[:G],
            "sumsq": np.bincount(gg, vm * vm, G + 1)[:G],
            "scale.sum": np.bincount(gg, np.abs(vm), G + 1)[:G],
            "scale.sumsq": np.bincount(gg, vm * vm, G + 1)[:G]}


def compare_single(kres, pres, truth, integer, what) -> dict:
    """B4/B5 against their plain versions: counts, min and max equal (NaN
    where the plain one is NaN; where a min or max is zero, its sign bit
    too, since -0.0 == 0.0).  A sum is within 1e-5 of the group's
    sum of |v| (of v*v) of the float64 sum, exactly equal to it on
    integer inputs below 2^24, and within that plus the plain version's
    own distance from it of the plain sum (f32 sums in one bin over
    800k rows drift by a few 1e-5: the kernel's block sums are closer).
    Returns per key the max abs difference from the plain version over
    the non-NaN entries."""
    err = {}
    if sorted(kres) != sorted(pres):
        raise AssertionError(f"{what}: keys {sorted(kres)}")
    for key in pres:
        k = kres[key].cpu().numpy().astype(np.float64)
        p = pres[key].cpu().numpy().astype(np.float64)
        nan = np.isnan(p)
        if not np.array_equal(nan, np.isnan(k)):
            raise AssertionError(f"{what}: {key} NaN positions differ")
        k, p = k[~nan], p[~nan]
        d = np.abs(k - p)
        if key in ("count", "min", "max"):
            if (d != 0).any():
                i = int(np.argmax(d))
                raise AssertionError(f"{what}: {key} {k[i]} vs {p[i]}")
            z = p == 0
            if (np.signbit(k[z]) != np.signbit(p[z])).any():
                raise AssertionError(f"{what}: {key} signs of zero differ")
        else:
            sc = truth["scale." + key][~nan]
            t = truth[key][~nan]
            dk, dp = np.abs(k - t), np.abs(p - t)
            exact = (sc < 2 ** 24) if integer else np.zeros_like(d, bool)
            bad = ((dk[exact] != 0).any() or (dk > 1e-5 * sc).any()
                   or (d > 1e-5 * sc + dp).any())
            if bad:
                i = int(np.argmax(dk - 1e-5 * sc))
                raise AssertionError(f"{what}: {key} {k[i]} vs plain {p[i]}"
                                     f", float64 {t[i]} (scale {sc[i]})")
        err[key] = float(d.max()) if d.size else 0.0
    return err


def bits_equal(a: dict, b: dict) -> bool:
    """Whether two stat dicts hold the same bits (NaNs included)."""
    return all(torch.equal(a[k].view(torch.int32), b[k].view(torch.int32))
               for k in a)


def compare_multi(kres, pres, g, valid, ops, G, integer, what) -> dict:
    """The fused kernel's dict against its plain version's: the base
    count equal, then each operand under `compare_single`."""
    if sorted(kres) != sorted(pres):
        raise AssertionError(f"{what}: keys {sorted(kres)}")
    if not torch.equal(kres["g.None.count"], pres["g.None.count"]):
        raise AssertionError(f"{what}: base count differs")
    err = {"count": 0.0}
    for j, (v, p) in enumerate(ops):
        pre = f"g.{j}."
        e = compare_single(
            {k[len(pre):]: x for k, x in kres.items() if k.startswith(pre)},
            {k[len(pre):]: x for k, x in pres.items() if k.startswith(pre)},
            f64_sums(g, valid & p, v, G), integer, f"{what} operand {j}")
        for k, x in e.items():
            err[k] = max(err.get(k, 0.0), x)
    return err


def phase_single_groupby_vs_plain(dev) -> tuple:
    """The fused single-query kernel against its plain version on every
    GB1_CASES case (one operand) and every GB1_OPS_CASES case, with and
    without min/max, through `groupby_aggregate_multi` (masking
    included); where the histograms sit in shared memory a second launch
    must give bit-identical sums.  The one-operand entry
    `groupby_aggregate` against `groupby_aggregate_plain` on the
    GB1_CASES.  Returns the max errors of the sums and of min/max."""
    rng = np.random.default_rng(19)
    err_s = err_m = 0.0
    cases = ([(n, G, 1, False, integer) for n, G, integer in GB1_CASES]
             + GB1_OPS_CASES)
    for n, G, n_ops, const, integer in cases:
        g, valid, ops = single_gb_operands(rng, dev, n, G, n_ops, const,
                                           integer)
        for mm in (True, False):
            kres = GB.groupby_aggregate_multi(g, valid, ops, G, mm)
            again = GB.groupby_aggregate_multi(g, valid, ops, G, mm)
            pres = GB.groupby_aggregate_multi_plain(g, valid, ops, G, mm)
            torch.cuda.synchronize()
            what = (f"fused single-query kernel vs plain [n={n} G={G} "
                    f"ops={n_ops} const={const} minmax={mm}]")
            e = compare_multi(kres, pres, g, valid, ops, G, integer, what)
            err_s = max(err_s, *(e.get(k, 0.0)
                                 for k in ("count", "sum", "sumsq")))
            err_m = max(err_m, e.get("min", 0.0), e.get("max", 0.0))
            C = GB._single_channels(min(n_ops, GB.MAX_OPS), mm)  # launch 1
            blocks, warps, rpb, shared = GB._single_geometry(
                n, C, GB._g_pad(G), GB._n_sm(dev.index))
            stable = bits_equal(kres, again)
            if shared and not stable:
                raise AssertionError(f"{what}: two launches differ")
            cnt = pres["g.None.count"].cpu().numpy()
            log(f"phase single-groupby-vs-plain: n={n} G={G} ops={n_ops}"
                f"{' (last a 0-dim constant)' if const else ''} minmax={mm} "
                f"{'integer' if integer else 'normal+NaN'} values, "
                f"{'shared' if shared else 'global'} branch, blocks="
                f"{blocks} warps={warps} rows/block={rpb}"
                f"{' + merge pass' if shared and blocks > 1 else ''}, rows="
                f"{int(cnt.sum())}, empty groups={int((cnt == 0).sum())}, "
                f"bit-identical relaunch={stable}, max_abs_err="
                f"{max(e.values()):.3g} ok")
            del kres, again, pres
        if n_ops == 1 and not const:
            v = ops[0][0]
            kres = GB.groupby_aggregate(g, valid, v, G, want_minmax=True)
            pres = GB.groupby_aggregate_plain(g, valid, v, G,
                                              want_minmax=True)
            torch.cuda.synchronize()
            e = compare_single(kres, pres, f64_sums(g, valid, v, G), integer,
                               f"groupby_aggregate vs plain [n={n} G={G}]")
            err_s = max(err_s, e["count"], e["sum"], e["sumsq"])
            err_m = max(err_m, e["min"], e["max"])
            del kres, pres
        del g, valid, ops
    torch.cuda.synchronize()
    log(f"phase single-groupby-vs-plain: {2 * len(cases)} fused cases and "
        f"{len(GB1_CASES)} one-operand cases == plain")
    phase_signed_zero_groups(dev)
    return err_s, err_m


def phase_signed_zero_groups(dev):
    """MIN/MAX of signed zeros in IEEE-754 minimum/maximum order, as the
    JAX package gives them: group 0 holds only -0.0 (min and max -0.0),
    group 1 -0.0 and +0.0 (min -0.0, max +0.0), group 2 those and -1.0
    (min -1.0, max +0.0).  One block (1,000 rows), many blocks and the
    merge pass (the `*` shape's 1,000,064 rows) and the global branch (G
    = 65,536); kernel against plain under `compare_multi` (sign bits
    compared) and against the wanted values, sign bits included."""
    rng = np.random.default_rng(23)
    want_lo = np.array([-0.0, -0.0, -1.0], np.float32)
    want_hi = np.array([-0.0, 0.0, 0.0], np.float32)
    for n, G in ((1000, 3), (N_PAD_1M, 3), (9000, 65536)):
        g = rng.integers(0, 3, n).astype(np.int32)
        v = np.where(rng.random(n) < 0.5, -0.0, 0.0).astype(np.float32)
        v[g == 0] = -0.0
        v[np.flatnonzero(g == 1)[:2]] = (-0.0, 0.0)
        v[np.flatnonzero(g == 2)[:3]] = (-0.0, 0.0, -1.0)
        gt = torch.as_tensor(g, device=dev)
        valid = torch.ones(n, dtype=torch.bool, device=dev)
        ops = [(torch.as_tensor(v, device=dev), valid)]
        kres = GB.groupby_aggregate_multi(gt, valid, ops, G, True)
        pres = GB.groupby_aggregate_multi_plain(gt, valid, ops, G, True)
        torch.cuda.synchronize()
        what = f"signed zeros [n={n} G={G}]"
        compare_multi(kres, pres, gt, valid, ops, G, True, what)
        for key, want in (("min", want_lo), ("max", want_hi)):
            got = kres[f"g.0.{key}"][:3].cpu().numpy()
            if not (np.array_equal(got, want)
                    and np.array_equal(np.signbit(got), np.signbit(want))):
                raise AssertionError(f"{what}: {key} {got.tolist()} != "
                                     f"{want.tolist()}")
        log(f"phase single-groupby-vs-plain: signed zeros n={n} G={G}: min "
            f"{want_lo.tolist()} max {want_hi.tolist()} (sign bits equal) "
            f"== plain")


# ---------------------------------------------------------------- phase 4
def make_corpus(n_docs: int, seed: int = 0):
    """bench.py's corpus: 4+20 zipf(1.25) tokens over a 200k vocab.
    Returns (docs, query terms, token ids int32 [n_docs, 24]: title
    then body)."""
    rng = np.random.default_rng(seed)
    vocab = 200_000
    words = np.array(["w%06d" % i for i in range(vocab)])
    zipf = np.clip(rng.zipf(1.25, size=(n_docs, 24)) - 1, 0, vocab - 1)
    cats = np.array(["cat%02d" % i for i in range(16)])
    cat2 = np.array(["g%04d" % i for i in range(1000)])
    price = rng.integers(1, 10_000, n_docs)
    docs = [(f"d{i}", {"title": " ".join(words[zipf[i, :4]]),
                       "body": " ".join(words[zipf[i, 4:]]),
                       "cat": cats[i % 16],
                       "grp": cat2[i % 1000],
                       "price": float(price[i])})
            for i in range(n_docs)]
    qt = ["w%06d" % i for i in rng.integers(20, 5000, size=512)]
    return docs, qt, zipf.astype(np.int32)


def bm25_fields():
    F, T = rt.Field, rt.FieldType
    return [F("title", T.TEXT, weight=2.0), F("body", T.TEXT),
            F("cat", T.TAG), F("grp", T.TAG, sortable=True),
            F("price", T.NUMERIC, sortable=True)]


def query_route(ix, seg, q: str, opts=None) -> str:
    """The executor the engine's router gives `q`, in `_rows_executor`'s
    order: the intersection kernel's route ("kernel" or "kernel-wide",
    `_kernel_route`), else "phrase-kernel", else "window"."""
    cq = ix.prepare(q, None, opts or E.QueryOptions(k=K), 2)
    _row, ent = cq.bind_row(seg)
    k_pad = int(min(E.next_pow2(K), seg.n_pad))
    route = E._kernel_route(cq, seg, ent[4], k_pad)
    if route is not None:
        return route[0]
    if E._kernel_plan_phrase(cq, seg, ent[4], k_pad) is not None:
        return "phrase-kernel"
    return "window"


def kernel_eligible(ix, seg, q: str, opts=None) -> bool:
    """Whether a kernel serves `q` (any route but the window program)."""
    return query_route(ix, seg, q, opts) != "window"


class window_program:
    """Within the block the engine's router sends every batch group to
    the general window program (no kernel route), as the JAX package
    serves the queries its kernel planner refuses."""

    def __enter__(self):
        self.saved = E._kernel_route, E._kernel_plan_phrase
        E._kernel_route = lambda *a, **k: None
        E._kernel_plan_phrase = lambda *a, **k: None

    def __exit__(self, *exc):
        E._kernel_route, E._kernel_plan_phrase = self.saved


def plain_results(ix, seg, queries, opts=None):
    """The engine's results for `queries` with each kernel's plain
    version in its place (`plain_versions`): ([SegmentResult], the size
    of the largest group)."""
    cqs = [ix.prepare(q, None, opts or E.QueryOptions(k=K), 2)
           for q in queries]
    largest = max(len(s[0]) for s in E._prep_subs(cqs, seg, K))
    with plain_versions():
        return E.execute_batch(cqs, seg, K), largest


def check_against_plain(kres, pres, what):
    """Served results against their plain recomputation: counts and the
    live lanes' docs equal, scores within SCORE_RTOL.  Returns the max
    abs score difference."""
    err = 0.0
    for i, (kr, pr) in enumerate(zip(kres, pres)):
        live = pr.scores > -3.3e38
        if kr.count != pr.count or not np.array_equal(
                kr.local_idx[live], pr.local_idx[live]) or not np.array_equal(
                kr.scores <= -3.3e38, ~live):
            raise AssertionError(f"{what} query {i}: kernel {kr.count} "
                                 f"{kr.local_idx} vs plain {pr.count} "
                                 f"{pr.local_idx}")
        np.testing.assert_allclose(kr.scores[live], pr.scores[live],
                                   rtol=SCORE_RTOL, atol=0,
                                   err_msg=f"{what} query {i}")
        if live.any():
            err = max(err, float(np.abs(kr.scores[live]
                                        - pr.scores[live]).max()))
    return err


def numpy_and2_count(seg, ix, q: str) -> int:
    """Match count of an and2 query from the host-copied postings."""
    return len(numpy_and2_docs(seg, ix, q))


def numpy_and2_docs(seg, ix, q: str) -> np.ndarray:
    """Matching local doc ids of an and2 query from the host-copied
    postings: the doc sets of each token group (the token and its
    expansions, field mask tested) intersected with numpy."""
    cq = ix.prepare(q, None, E.QueryOptions(k=K), 2)
    binding, _P = cq.bind(seg)
    dyn = binding.dyn
    sets = []
    for leaf, _idx in cq.leaves():
        docs = []
        for s in range(leaf.lo, leaf.hi):
            a, n = int(dyn["tstarts"][s]), int(dyn["tlens"][s])
            d = seg.text.doc_ids[a:a + n].cpu().numpy()
            m = seg.text.field_masks[a:a + n].cpu().numpy()
            docs.append(d[(m & int(dyn["tmasks"][s])) != 0])
        sets.append(np.unique(np.concatenate(docs)) if docs
                    else np.zeros(0, np.int32))
    return np.intersect1d(sets[0], sets[1])


def time_ms(fn, iters: int = 20) -> float:
    """Device time of one call of fn, in ms: CUDA events around `iters`
    calls.  The calls are enqueued while the card spins in a
    `torch.cuda._sleep` long enough to cover the host's enqueue time, so
    that the events time the device's work and not the host's launch
    gaps between the calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    h0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_s = time.perf_counter() - h0
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(max(2.0 * host_s, 1e-3), 2.0) * 2e9))
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def bound_ms(n_bytes: float) -> float:
    """The least time the card could take to move n_bytes at its memory
    rate.  Every kernel here does a handful of integer or f32 operations
    per byte it reads, far below the 67 TFLOP/s f32 rate, so bytes bound
    them all."""
    return n_bytes / HBM_BYTES_PER_S * 1e3


def intersect_bytes(meta, fmeta, T, groups, pivot_g, outs) -> int:
    """Bytes this batch needs the intersection kernel to move: every live
    posting of the pivot slots (doc, freq, mask and doc length), one
    probe of each other slot per pivot posting, at most its live length
    (doc, freq and mask for a text slot, the doc for an aux tag slot),
    the per-query meta and the outputs."""
    srcs = IK._slot_srcs(T, groups)
    lens = meta[:, T:2 * T].to(torch.int64)
    piv = list(groups[pivot_g][1])
    plen = lens[:, piv].sum(1)
    n = 16 * int(plen.sum())
    for t in range(T):
        if t not in piv:
            n += (12 if srcs[t] < 0 else 4) * int(
                torch.minimum(lens[:, t], plen).sum())
    return n + nbytes(meta, fmeta, *outs)


def phrase_bytes(meta, fmeta, T, outs) -> int:
    """Bytes this batch needs the phrase kernel to move: term 0's live
    position keys, one probe of each later term's keys per term-0 key
    (at most its live length), and for the queries that match, term 0's
    postings (16 bytes each) and one probe of each later slot's postings
    per term-0 posting (12 bytes); then the meta and the outputs."""
    pl = meta[:, 4 * T:5 * T].to(torch.int64)
    tl = meta[:, T:2 * T].to(torch.int64)[outs[2] > 0]
    n = 4 * int(pl[:, 0].sum()) + 16 * int(tl[:, 0].sum())
    for t in range(1, T):
        n += 4 * int(torch.minimum(pl[:, t], pl[:, 0]).sum())
        n += 12 * int(torch.minimum(tl[:, t], tl[:, 0]).sum())
    return n + nbytes(meta, fmeta, *outs)


def phase_main_path(dev, n_docs: int, batch: int) -> dict:
    """Ingest, serve the eight families once with the launch counters
    zeroed just before and read just after, hold every query against its
    plain recomputation, then the check-only phrase runs, QPS, kernel
    times and the profile.  Returns the numbers of the kernels' JSON
    line, the client and the index."""
    t0 = time.perf_counter()
    docs, qt, toks = make_corpus(n_docs)
    log(f"phase main-path: corpus {n_docs} docs generated in "
        f"{time.perf_counter() - t0:.1f}s")
    client = rt.Client(device=dev)
    ix = client.ft_create("bm25", bm25_fields())
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    ix.add_documents(docs)
    torch.cuda.synchronize(dev)
    ingest_s = time.perf_counter() - t0
    seg = ix.segments[0]
    log(f"phase main-path: ingest {n_docs} docs in {ingest_s:.1f}s "
        f"({n_docs / ingest_s:.0f} docs/s), segment nnz={seg.text.nnz} "
        f"device bytes={seg.memory_bytes()} pos_stride={seg.text.pos_stride}")

    batches, routes = {}, {}
    want: dict = {}
    for fam, fn in FAMILIES.items():
        qs = [fn(qt, i) for i in range(batch)]
        routes[fam] = [query_route(ix, seg, q) for q in qs]
        batches[fam] = qs
        for r in routes[fam]:
            want[r] = want.get(r, 0) + 1
        n_win = routes[fam].count("window")
        log(f"phase main-path: {fam}: routes "
            f"{ {r: routes[fam].count(r) for r in sorted(set(routes[fam]))} }"
            f", kernel-eligible {100.0 * (len(qs) - n_win) / len(qs):.2f}%")
    # bench.py's kernel_hit_pct: the share of the eight families' queries
    # that ride a kernel; since the wide route, the window program none
    n_all = batch * len(FAMILIES)
    n_ok = n_all - want.get("window", 0)
    log(f"phase main-path: kernel_hit_pct {100.0 * n_ok / n_all:.2f} "
        f"({n_ok} of {n_all} queries of the {len(FAMILIES)} families), "
        f"window share {100.0 * (n_all - n_ok) / n_all:.2f} "
        f"({n_all - n_ok} queries), kernel-wide "
        f"{want.get('kernel-wide', 0)} queries")
    if n_ok != n_all or not want.get("kernel-wide"):
        raise AssertionError(f"the router leaves queries to the window "
                             f"program or has no wide query: {want}")
    seg.tag_pcodes("cat")     # set-up: the dense code column, built once

    # the counted main-path run: counters zeroed just before, read after
    E.QUERY_PATH_STATS.clear()
    IK.LAUNCHES = IK.WIDE_LAUNCHES = 0
    IK.PHRASE_LAUNCHES = 0
    results = {fam: client.ft_search_many("bm25", qs, k=K)
               for fam, qs in batches.items()}
    torch.cuda.synchronize(dev)
    launches, p_launches = IK.LAUNCHES, IK.PHRASE_LAUNCHES
    w_launches = IK.WIDE_LAUNCHES
    stats = {r: n for r, n in E.QUERY_PATH_STATS.items() if n}
    log(f"phase main-path: intersect launches={launches} (wide "
        f"{w_launches}), phrase launches={p_launches}, path stats={stats}, "
        f"served={n_all}")
    if launches - w_launches <= 0 or w_launches <= 0 or p_launches <= 0:
        raise AssertionError("a kernel of the main path never launched")
    if stats != want:
        raise AssertionError(f"not every served query rode its kernel: "
                             f"{stats}, want {want}")
    for fam, res in results.items():
        for r in res:
            if len(r.hits) > K or r.total < len(r.hits) or any(
                    not np.isfinite(h.score) for h in r.hits):
                raise AssertionError(f"{fam}: malformed result {r.total} "
                                     f"{[h.score for h in r.hits]}")
        log(f"phase main-path: {fam}: queries with hits="
            f"{sum(1 for r in res if r.hits)}/{len(res)}, mean total="
            f"{np.mean([r.total for r in res]):.3f}")

    # every query of each family, kernel vs plain (groups larger than the
    # kernel's grid have blocks serve several queries)
    err = {"intersect": 0.0, "phrase": 0.0}
    for fam, qs in batches.items():
        kres = E.execute_batch(
            [ix.prepare(q, None, E.QueryOptions(k=K), 2) for q in qs],
            seg, K)
        pres, largest = plain_results(ix, seg, qs)
        name = "phrase" if fam == "phrase" else "intersect"
        err[name] = max(err[name], check_against_plain(kres, pres, fam))
        hits = [h.key for h in results[fam][0].hits]
        want = [ix.doctable.get(int(seg.gids_np[d])).key
                for d in kres[0].local_idx[kres[0].scores > -3.3e38]]
        if hits != want:
            raise AssertionError(f"{fam}: served hits {hits} != {want}")
        log(f"phase main-path: {fam}: all {len(qs)} queries kernel == "
            f"plain (largest group {largest})")
    check_wide_against_window(ix, seg, batches, routes, results)
    for q in batches["and2"][:16]:
        r = client.ft_search_many("bm25", [q], k=K)[0]
        want = numpy_and2_count(seg, ix, q)
        if r.total != want:
            raise AssertionError(f"and2 {q!r}: total {r.total} != numpy "
                                 f"intersection {want}")
    log("phase main-path: 16 and2 totals == numpy set intersections")
    check_single_search(ix, results, qt)
    err["phrase"] = max(err["phrase"], phase_phrase_runs(ix, seg, toks))
    del toks

    phase_qps(client, ix, seg, batches, dev)
    log(f"phase main-path: max_memory_allocated="
        f"{torch.cuda.max_memory_allocated(dev)}")
    times = phase_kernel_times(ix, seg, batches, dev)
    phase_profile(client, ix, seg, batches, dev)
    # the corpus stays for phase 10 (the same documents, cold)
    return dict(launches=launches - w_launches, w_launches=w_launches,
                p_launches=p_launches, err=err, times=times, client=client,
                ix=ix, docs=docs, qt=qt)


def check_wide_against_window(ix, seg, batches, routes, results):
    """The served hits of every query on the wide route against the
    engine's results for the same queries with the window program forced
    on (what the JAX package serves them with): totals, hit docs in
    order, scores within 1e-5."""
    n = 0
    for fam, qs in batches.items():
        wide = [q for q, r in zip(qs, routes[fam]) if r == "kernel-wide"]
        if not wide:
            continue
        served = [r for r, rt_ in zip(results[fam], routes[fam])
                  if rt_ == "kernel-wide"]
        cqs = [ix.prepare(q, None, E.QueryOptions(k=K), 2) for q in wide]
        with window_program():
            wres = E.execute_batch(cqs, seg, K)
        for q, s_, w in zip(wide, served, wres):
            live = w.scores > -3.3e38
            keys = [ix.doctable.get(int(seg.gids_np[d])).key
                    for d in w.local_idx[live]]
            if s_.total != w.count or [h.key for h in s_.hits] != keys:
                raise AssertionError(f"wide {q!r}: served {s_.total} "
                                     f"{[h.key for h in s_.hits]} vs window "
                                     f"program {w.count} {keys}")
            np.testing.assert_allclose([h.score for h in s_.hits],
                                       w.scores[live], rtol=1e-5, atol=0,
                                       err_msg=f"wide {q!r}")
        n += len(wide)
    log(f"phase main-path: all {n} kernel-wide queries == the window "
        f"program's results (totals, hits in order, scores rtol 1e-5)")


def same_hits(a, b, what):
    """Two results of one query: totals equal, scores within 1e-5 lane
    by lane, and the same docs lane by lane except where two scores tie
    within 1e-5 (their order may differ at the last bit)."""
    sa = np.array([h.score for h in a.hits])
    sb = np.array([h.score for h in b.hits])
    if a.total != b.total or len(sa) != len(sb):
        raise AssertionError(f"{what}: totals {a.total} vs {b.total}, "
                             f"{len(sa)} vs {len(sb)} hits")
    np.testing.assert_allclose(sa, sb, rtol=1e-5, atol=0, err_msg=what)
    allsc = np.concatenate([sa, sb])
    for i, (ha, hb) in enumerate(zip(a.hits, b.hits)):
        if ha.key != hb.key and (np.sum(np.abs(allsc - sa[i])
                                        <= 1e-5 * abs(sa[i])) < 3):
            raise AssertionError(f"{what}: hit {i} {ha.key} vs {hb.key}")


def check_single_search(ix, results, qt, n_each: int = 64):
    """`ix.search(q)` (the general window program, one query) against the
    served `ft_search_many` result (the kernels) for the first n_each
    queries of each family."""
    n = 0
    for fam, res in results.items():
        qs = [FAMILIES[fam](qt, i) for i in range(n_each)]
        for q, r in zip(qs, res):
            same_hits(ix.search(q, num=K), r, f"search vs search_many "
                      f"[{fam} {q!r}]")
            n += 1
    log(f"phase main-path: {n} single ix.search() (window program) == "
        f"ft_search_many (kernels), {n_each} per family")


# a phrase the reference's in-order proximity model accepts: a port of
# RediSearch's proximity.rs within_range_in_order (tests/
# test_fuzz_proximity.py holds the same model; that module imports the
# JAX package, which this script must not load)
def within_range_in_order(lists, max_slop):
    n = len(lists)
    iters = [iter(x) for x in lists]
    pos = [0] * n
    while True:
        p0 = next(iters[0], None)
        if p0 is None:
            return False
        pos[0] = p0
        span = 0
        over = False
        for i in range(1, n):
            last = pos[i - 1]
            p = pos[i]
            while p < last:
                p = next(iters[i], None)
                if p is None:
                    return False
            pos[i] = p
            span += p - last - 1
            if span > 0 and span > max_slop:
                over = True
                break
        if not over:
            return True


def model_phrase_docs(toks, words, slop) -> set:
    """Docs (corpus row numbers) whose tokens hold `words` in order
    within `slop`, by the proximity model over the host-copied tokens.
    Positions are 1-based, as the model expects (its iterators start at
    0), with the index's one-position gap between TEXT fields: title
    tokens 1..4, body tokens 6..25."""
    ids = [int(w[1:]) for w in words]
    rows = np.flatnonzero(np.all([(toks == t).any(axis=1) for t in ids],
                                 axis=0))
    pos_of = 1 + np.r_[np.arange(4), 5 + np.arange(toks.shape[1] - 4)]
    return {int(r) for r in rows if within_range_in_order(
        [pos_of[toks[r] == t].tolist() for t in ids], slop)}


def phase_phrase_runs(ix, seg, toks, n_each: int = 256) -> float:
    """Check-only phrases that do match: 2-4-term exact phrases and
    slop-1 in-order phrases cut from the corpus's own body token runs
    (the slop-1 ones skip one token), drawn until n_each of each kind
    ride the phrase kernel.  Every query must ride it and match its
    source doc, equal its plain recomputation, and 16 must equal the
    proximity model's doc set.  Returns the max abs score difference."""
    rng = np.random.default_rng(17)
    words = lambda ids: ["w%06d" % t for t in ids]
    kinds = {"exact": ([], E.QueryOptions(k=K)),
             "slop1-inorder": ([], E.QueryOptions(k=K, slop=1,
                                                  inorder=True))}
    drawn = 0
    while min(len(v[0]) for v in kinds.values()) < n_each:
        drawn += 1
        r, T = int(rng.integers(0, toks.shape[0])), int(rng.integers(2, 5))
        j = 4 + int(rng.integers(0, toks.shape[1] - 4 - T))
        for kind, (qs, opts) in kinds.items():
            if len(qs) >= n_each:
                continue
            cols = (list(range(j, j + T)) if kind == "exact"
                    else [j] + list(range(j + 2, j + T + 1)))
            w = words(toks[r, cols])
            q = f'"{" ".join(w)}"' if kind == "exact" else " ".join(w)
            if kernel_eligible(ix, seg, q, opts):
                qs.append((q, w, r))
    err = 0.0
    for kind, (qs, opts) in kinds.items():
        slop = 0 if kind == "exact" else 1
        qstr = [q for q, _w, _r in qs]
        cqs = [ix.prepare(q, None, opts, 2) for q in qstr]
        E.QUERY_PATH_STATS.clear()
        IK.PHRASE_LAUNCHES = 0
        kres = E.execute_batch(cqs, seg, K)
        if dict(E.QUERY_PATH_STATS) != {"phrase-kernel": len(qs)} or \
                IK.PHRASE_LAUNCHES <= 0:
            raise AssertionError(f"phrase runs {kind}: "
                                 f"{E.QUERY_PATH_STATS}, launches "
                                 f"{IK.PHRASE_LAUNCHES}")
        if any(kr.count < 1 for kr in kres):
            raise AssertionError(f"phrase runs {kind}: a phrase cut from a "
                                 f"doc does not match it")
        pres, _largest = plain_results(ix, seg, qstr, opts)
        err = max(err, check_against_plain(kres, pres, f"runs {kind}"))
        for (q, w, r), kr in list(zip(qs, kres))[:8]:
            want = model_phrase_docs(toks, w, slop)
            got = {int(ix.doctable.get(int(seg.gids_np[d])).key[1:])
                   for d in kr.local_idx[kr.scores > -3.3e38]}
            if kr.count != len(want) or not got <= want or r not in want:
                raise AssertionError(f"phrase runs {kind} {q!r}: total "
                                     f"{kr.count}, model {len(want)}")
        log(f"phase main-path: phrase runs {kind}: {len(qs)} phrases of "
            f"2-4 terms ({drawn} draws), all rode the phrase kernel, "
            f"mean total {np.mean([kr.count for kr in kres]):.2f}, all "
            f"equal to plain; 8 equal to the in-order proximity model "
            f"(slop {slop}) over the host-copied tokens")
    return err


def warm_qps(client, batches, dev) -> dict:
    """QPS a family of "bm25": sequential `ft_search_many` batches, host
    clock ending in a synchronize, best of 2."""
    out = {}
    for fam, qs in batches.items():
        best = None
        for _ in range(2):
            t0 = time.perf_counter()
            client.ft_search_many("bm25", qs, k=K)
            torch.cuda.synchronize(dev)
            dt = time.perf_counter() - t0
            best = dt if best is None else min(best, dt)
        out[fam] = len(qs) / best
    return out


def phase_qps(client, ix, seg, batches, dev, iters: int = 4):
    """Information only: QPS per family, host clock, ending in a sync:
    sequential `ft_search_many` batches (best of 2), then bench.py's
    pipelined loop over `execute_batch(async_=True)` at depth 2, which
    prepares the next batch while the card runs this one (best of 2)."""
    for fam, qps in warm_qps(client, batches, dev).items():
        log(f"phase main-path: qps {fam}: {qps:.1f} "
            f"(batch {len(batches[fam])}, best of 2, host clock)")
    opts = E.QueryOptions(k=K)
    total_q = total_s = 0.0
    for fam, qs in batches.items():
        best = None
        for _ in range(2):
            t0 = time.perf_counter()
            pending = []
            nxt = [ix.prepare(q, None, opts, 2) for q in qs]
            for it in range(iters):
                pending.append(E.execute_batch(nxt, seg, K, async_=True))
                if it + 1 < iters:
                    nxt = [ix.prepare(q, None, opts, 2) for q in qs]
                if len(pending) > 2:
                    pending.pop(0).result()
            for h in pending:
                h.result()
            dt = time.perf_counter() - t0
            best = dt if best is None else min(best, dt)
        total_q += iters * len(qs)
        total_s += best
        log(f"phase main-path: pipelined qps {fam}: "
            f"{iters * len(qs) / best:.1f} ({iters} batches of {len(qs)}, "
            f"depth 2, best of 2, host clock)")
    log(f"phase main-path: pipelined qps, {len(batches)} families: "
        f"{total_q / total_s:.1f}")


def intersect_group_args(entry, seg_args, rows, dev) -> tuple:
    """(args, kwargs) of the intersection kernel's call for one batch
    group on its executor."""
    stacked = E._device_unpack_rows(entry.layout,
                                    torch.from_numpy(rows).to(dev))
    meta, fmeta, aux = E._kernel_batched_inputs(
        stacked, seg_args, entry.descs, entry.aux_keys, entry.dmeta)
    args = (meta, fmeta, seg_args["doc_ids"], seg_args["freqs"],
            seg_args["field_masks"], seg_args["posting_dl"], *aux)
    kw = dict(T=len(entry.descs), Ws=entry.Ws, groups=entry.groups,
              pivot_g=entry.pivot_g, k=entry.k_pad, dense=entry.dense)
    return args, kw


def time_intersect_group(what, idxs, args, kw) -> tuple:
    """The intersection kernel on one group against its plain version:
    compared lane for lane, then timed (device ms, plain/kernel/plain/
    kernel).  Returns (kernel ms, plain ms, max abs err, bound ms)."""
    kout = IK.intersect_batch(*args, **kw)
    e = compare_raw(kout, IK.intersect_plain(*args, **kw),
                    f"kernel vs plain [{what} group of {len(idxs)}]")
    b = bound_ms(intersect_bytes(args[0], args[1], kw["T"], kw["groups"],
                                 kw["pivot_g"], kout))
    p1 = time_ms(lambda: IK.intersect_plain(*args, **kw), 5)
    k1 = time_ms(lambda: IK.intersect_batch(*args, **kw))
    p2 = time_ms(lambda: IK.intersect_plain(*args, **kw), 5)
    k2 = time_ms(lambda: IK.intersect_batch(*args, **kw))
    log(f"phase main-path: {what} largest group B={len(idxs)} Ws={kw['Ws']} "
        f"groups={kw['groups']} k={kw['k']}: kernel lanes == plain lanes "
        f"(bit-identical); kernel {k1:.4f}/{k2:.4f} ms, plain "
        f"{p1:.4f}/{p2:.4f} ms (device ms, plain/kernel/plain/kernel), "
        f"bytes bound {b:.4f} ms")
    return min(k1, k2), min(p1, p2), e, b


def phase_kernel_times(ix, seg, batches, dev) -> dict:
    """Information only: each kernel against its plain version at the
    main path's shapes (device ms, plain/kernel/plain/kernel): the
    largest and2 group, the largest kernel-wide group of or2 (beside the
    window program's device and host time for the same queries), and
    every group of the phrase family (one per window-bucket
    combination).  Each pair is also compared.  Returns {name: (kernel
    ms, plain ms, max abs err, bound ms)} of the largest group."""
    out = {}
    cqs = [ix.prepare(q, None, E.QueryOptions(k=K), 2)
           for q in batches["and2"]]
    subs = [s_ for s_ in E._prep_subs(cqs, seg, K)
            if isinstance(s_[1], E._KernelExecutor)]
    idxs, entry, seg_args, rows = max(subs, key=lambda s: len(s[0]))
    out["intersect"] = time_intersect_group(
        "and2", idxs, *intersect_group_args(entry, seg_args, rows, dev))

    cqs = [ix.prepare(q, None, E.QueryOptions(k=K), 2)
           for q in batches["or2"]]
    subs = [s_ for s_ in E._prep_subs(cqs, seg, K)
            if s_[1].path == "kernel-wide"]
    idxs, entry, seg_args, rows = max(subs, key=lambda s: len(s[0]))
    out["intersect_wide"] = time_intersect_group(
        "or2 kernel-wide", idxs,
        *intersect_group_args(entry, seg_args, rows, dev))
    # the window program on the same queries (as the JAX package serves
    # them): the device's busy time in a torch.profiler trace of one run
    # (its ops are many and small), and the host clock of that run
    from torch.profiler import ProfilerActivity, profile
    with window_program():
        wsub = E._prep_subs([cqs[i] for i in idxs], seg, K)
    (_wi, wentry, wargs, wrows), = wsub
    wentry.run(wargs, wrows)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        wentry.run(wargs, wrows)
        w_host = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
    w_dev = device_busy_us(prof)[0] / 1e3
    out["window_wide"] = (w_dev, w_host)
    log(f"phase main-path: the same {len(idxs)} or2 queries on the window "
        f"program: device {w_dev:.4f} ms, host launch {w_host:.3f} ms "
        f"(kernel-wide: {out['intersect_wide'][0]:.4f} ms)")

    cqs = [ix.prepare(q, None, E.QueryOptions(k=K), 2)
           for q in batches["phrase"]]
    subs = sorted((s_ for s_ in E._prep_subs(cqs, seg, K)
                   if isinstance(s_[1], E._PhraseExecutor)),
                  key=lambda s: -len(s[0]))
    for gi, (idxs, entry, seg_args, rows) in enumerate(subs):
        meta, fmeta = entry.inputs(seg_args, rows)
        args = (meta, fmeta, seg_args["doc_ids"], seg_args["freqs"],
                seg_args["field_masks"], seg_args["posting_dl"],
                seg_args["poskeys"])
        kw = dict(T=len(entry.slots), Ws=entry.Ws, PWs=entry.PWs,
                  stride=entry.stride, slop=entry.slop, k=entry.k_pad,
                  raw=entry.raw(dev))
        kout = IK.phrase_batch(*args, **kw)
        e = compare_raw(kout, IK.phrase_plain(*args, **kw),
                        f"phrase kernel vs plain [group of {len(idxs)}]")
        b = bound_ms(phrase_bytes(meta, fmeta, kw["T"], kout))
        p1 = time_ms(lambda: IK.phrase_plain(*args, **kw), 5)
        k1 = time_ms(lambda: IK.phrase_batch(*args, **kw))
        p2 = time_ms(lambda: IK.phrase_plain(*args, **kw), 5)
        k2 = time_ms(lambda: IK.phrase_batch(*args, **kw))
        if gi == 0:
            out["phrase"] = (min(k1, k2), min(p1, p2), e, b)
        log(f"phase main-path: phrase group B={len(idxs)} Ws={entry.Ws} "
            f"PWs={entry.PWs} raw={kw['raw']}: kernel lanes == plain "
            f"lanes; kernel {k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/{p2:.4f} "
            f"ms (device ms, plain/kernel/plain/kernel), bytes bound "
            f"{b:.4f} ms")
    return out


def save_b1_groups(path: str) -> None:
    """`--save-groups PATH`: build the main path's index, route the seven
    term-query families at BATCH and the aggregate request's batch of
    AGG_BATCH, and save every intersection-kernel group (both routes and
    raw mode) to PATH for `redisearch_tpu_torch/bench/ab.py intersect`:
    {"arrays": {key: CPU tensor}, "groups": [{"fam", "path", "n", "args"
    (keys of "arrays"), "kw", "bound_ms"}]}, largest group of a family
    first.  Runs no other phase."""
    phase_card()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    docs, qt, _toks = make_corpus(N_DOCS)
    client = rt.Client(device=dev)
    ix = client.ft_create("bm25", bm25_fields())
    ix.add_documents(docs)
    del docs
    seg = ix.segments[0]
    seg.tag_pcodes("cat")
    arrays, groups = {}, []

    def keep(fam, path, n, args, kw):
        outs = IK.intersect_plain(*args, **kw)
        b = bound_ms(intersect_bytes(args[0], args[1], kw["T"], kw["groups"],
                                     kw.get("pivot_g", 0), outs))
        names = []
        for t in args:     # the segment's arrays are saved once
            key = f"{t.data_ptr()}:{tuple(t.shape)}:{t.dtype}"
            arrays.setdefault(key, t)
            names.append(key)
        groups.append(dict(fam=fam, path=path, n=n, args=names, kw=kw,
                           bound_ms=b))

    for fam in FAMILIES:
        if fam == "phrase":
            continue
        cqs = [ix.prepare(FAMILIES[fam](qt, i), None, E.QueryOptions(k=K), 2)
               for i in range(BATCH)]
        subs = [s_ for s_ in E._prep_subs(cqs, seg, K)
                if isinstance(s_[1], E._KernelExecutor)]
        for idxs, entry, seg_args, rows in sorted(subs,
                                                  key=lambda s: -len(s[0])):
            keep(fam, entry.path, len(idxs),
                 *intersect_group_args(entry, seg_args, rows, dev))
    mk, _sd, _mm = agg_request_fn()
    reqs = [r for r in (mk(i) for i in range(2 * AGG_BATCH))
            if agg_eligible(ix, seg, r)][:AGG_BATCH]
    with capture_shapes() as cap:
        client.ft_aggregate_many("bm25", reqs)
    for args, kw in sorted(cap.args["intersect"].values(),
                           key=lambda c: -c[0][0].shape[0]):
        keep("raw-agg", "raw", args[0].shape[0], args, kw)
    torch.save({"arrays": {k: v.cpu() for k, v in arrays.items()},
                "groups": groups}, path)
    log(f"saved {len(groups)} intersection-kernel groups to {path}")


# ---------------------------------------------------------------- phase 5
def device_busy_us(prof, names=("intersect_kernel", "phrase_kernel")
                   ) -> tuple:
    """(busy us, {name: us}) from a torch.profiler trace: the union of
    the device-side (kernel and memcpy) intervals, and per kernel name
    the sum of its intervals."""
    spans, kern = [], dict.fromkeys(names, 0.0)
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            spans.append((ev.time_range.start, ev.time_range.end))
            for nm in names:
                if nm in ev.name:
                    kern[nm] += ev.time_range.elapsed_us()
    busy, end = 0.0, float("-inf")
    for s, e in sorted(spans):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy, kern


def phase_profile(client, ix, seg, batches, dev):
    """Information only: where one batch's time goes, per family.  The
    host stages of `ft_search_many`, each by the host clock over steady
    (already prepared) queries: prepare, bind (`_prep_subs`: rows,
    grouping, plans), launch (each group's upload, unpack and kernel
    launch), wait (`synchronize`), d2h (`_BatchHandle.result`); then the
    whole `ft_search_many` (rest = whole - the stages: hits and merge),
    and the device's busy time over one `ft_search_many` traced by
    torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    for fam, qs in batches.items():
        opts = E.QueryOptions(k=K)
        t = [time.perf_counter()]
        cqs = [ix.prepare(q, None, opts, 2) for q in qs]
        t.append(time.perf_counter())
        subs = E._prep_subs(cqs, seg, K)
        t.append(time.perf_counter())
        parts = [(idxs, entry.run(sa, rows))
                 for idxs, entry, sa, rows in subs]
        t.append(time.perf_counter())
        torch.cuda.synchronize(dev)
        t.append(time.perf_counter())
        E._BatchHandle(parts, len(cqs)).result()
        t.append(time.perf_counter())
        client.ft_search_many("bm25", qs, k=K)
        torch.cuda.synchronize(dev)
        t.append(time.perf_counter())
        ms = [(b - a) * 1e3 for a, b in zip(t, t[1:])]
        whole = ms[5]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            client.ft_search_many("bm25", qs, k=K)
            torch.cuda.synchronize(dev)
            traced = (time.perf_counter() - t0) * 1e3
        busy, kerns = device_busy_us(prof)
        kern = sum(kerns.values())
        log(f"phase profile: {fam} (batch {len(qs)}, {len(subs)} groups) "
            f"host ms: prepare {ms[0]:.3f}, bind {ms[1]:.3f}, launch "
            f"{ms[2]:.3f}, wait {ms[3]:.3f}, d2h {ms[4]:.3f}, whole "
            f"ft_search_many {whole:.3f}, rest {whole - sum(ms[:5]):.3f}; "
            f"traced ft_search_many {traced:.3f} ms with device busy "
            f"{busy:.1f} us (kernels {kern:.1f} us), idle share "
            f"{1.0 - busy / (traced * 1e3):.4f}")


# ---------------------------------------------------------------- phase 6
def agg_request_fn():
    """bench.py's FT.AGGREGATE request (bench_agg): 2-term text match
    with terms drawn from ranks 20..2000 -> GROUPBY @grp (1,000 values)
    COUNT / SUM / AVG(@price) -> SORTBY @s DESC -> LIMIT 0 10."""
    rng = np.random.default_rng(3)
    qt = ["w%06d" % i for i in rng.integers(20, 2000, size=256)]

    def query(i):
        return f"{qt[(2 * i) % 256]} {qt[(2 * i + 1) % 256]}"

    def mk(i):
        return (rt.AggregateRequest(query(i))
                .group_by("@grp", ("COUNT", [], "n"),
                          ("SUM", ["@price"], "s"),
                          ("AVG", ["@price"], "a"))
                .sort_by(("@s", rt.DESC)).limit(0, 10))

    def mk_sd(i):
        return (rt.AggregateRequest(query(i))
                .group_by("@grp", ("COUNT", [], "n"),
                          ("STDDEV", ["@price"], "sd"),
                          ("AVG", ["@price"], "a"))
                .sort_by("@grp"))

    def mk_mm(i):
        """bench_agg with MIN and MAX of the price added."""
        return (rt.AggregateRequest(query(i))
                .group_by("@grp", ("COUNT", [], "n"),
                          ("SUM", ["@price"], "s"),
                          ("AVG", ["@price"], "a"),
                          ("MIN", ["@price"], "lo"),
                          ("MAX", ["@price"], "hi"))
                .sort_by(("@s", rt.DESC)).limit(0, 10))
    return mk, mk_sd, mk_mm


def star_request(now: int):
    """bench.py's bench_agg_star request: '*' -> GROUPBY @grp -> COUNT /
    SUM(@price) -> SORTBY @s DESC -> LIMIT 0 10 over all 1M rows; the TTL
    clock varies per request, as bench.py varies it."""
    return (rt.AggregateRequest("*", now=now)
            .group_by("@grp", ("COUNT", [], "n"), ("SUM", ["@price"], "s"))
            .sort_by(("@s", rt.DESC)).limit(0, 10))


def agg_eligible(ix, seg, req) -> bool:
    """Whether the request rides the kernel-raw branch: a device plan
    without MIN/MAX, and an intersection-kernel plan whose pivots are
    text slots (the refusals are ROADMAP A6)."""
    cq = ix.prepare(req.query, req.params, AP._options(req), req.dialect)
    plan = AP._plan_device_group_cached(ix, req, cq)
    if plan is None or plan[3]:
        return False
    kp = E._kernel_plan(cq, seg, cq.bind_row(seg)[1][4], 16)
    return kp is not None and all(kp[0][p][0] == "t"
                                  for p in kp[2][kp[3]][1])


class plain_versions:
    """Within the block the engine's and the pipeline's ops run their
    plain torch versions on the card (for the recomputation the kernels
    are held against)."""

    def __enter__(self):
        self.saved = (IK.intersect_batch, IK.phrase_batch,
                      GB.groupby_aggregate_batch, GB.groupby_aggregate_multi)
        IK.intersect_batch = IK.intersect_plain
        IK.phrase_batch = IK.phrase_plain
        GB.groupby_aggregate_batch = GB.groupby_plain
        GB.groupby_aggregate_multi = GB.groupby_aggregate_multi_plain

    def __exit__(self, *exc):
        (IK.intersect_batch, IK.phrase_batch, GB.groupby_aggregate_batch,
         GB.groupby_aggregate_multi) = self.saved


class capture_shapes:
    """Within the block, record the arguments of each op's calls, one
    per distinct shape (the largest batch of each), calling through."""

    def __init__(self):
        self.args = {"intersect": {}, "groupby": {}}

    def _wrap(self, name, fn):
        def rec(*a, **k):
            # the trailing dims of the batched inputs + the static args
            key = (tuple(tuple(x.shape[1:]) for x in a[:2]),
                   tuple(x for x in a if not isinstance(x, torch.Tensor)),
                   tuple(sorted((kk, repr(v)) for kk, v in k.items())))
            old = self.args[name].get(key)
            if old is None or a[0].shape[0] > old[0][0].shape[0]:
                self.args[name][key] = (a, k)
            return fn(*a, **k)
        return rec

    def __enter__(self):
        self.saved = IK.intersect_batch, GB.groupby_aggregate_batch
        IK.intersect_batch = self._wrap("intersect", self.saved[0])
        GB.groupby_aggregate_batch = self._wrap("groupby", self.saved[1])
        return self

    def __exit__(self, *exc):
        IK.intersect_batch, GB.groupby_aggregate_batch = self.saved


def numpy_agg_top(seg, ix, q, grp_ids, table, price, docs=None):
    """(total, top-10 [(grp, n, s, min, max)]) of the bench request from
    the host-copied postings and columns (every doc when q is None):
    SUM desc, ties by ascending group id (the device tail's order)."""
    if docs is None:
        docs = numpy_and2_docs(seg, ix, q)
    g = np.where(grp_ids[docs] >= 0, grp_ids[docs], len(table))
    G = len(table) + 1
    p = price[docs].astype(np.float64)
    n = np.bincount(g, minlength=G)
    sm = np.bincount(g, weights=p, minlength=G)
    lo = np.full(G, np.inf)
    hi = np.full(G, -np.inf)
    np.minimum.at(lo, g, p)
    np.maximum.at(hi, g, p)
    present = np.flatnonzero(n > 0)
    order = present[np.lexsort((present, -sm[present]))][:10]
    keys = list(table) + [None]
    return len(docs), [(keys[i], float(n[i]), float(sm[i]), float(lo[i]),
                        float(hi[i])) for i in order]


def phase_aggregate(client, ix, dev) -> dict:
    seg = ix.segments[0]
    mk, mk_sd, _mk_mm = agg_request_fn()
    want = AGG_BATCH * AGG_BATCHES
    reqs, drawn = [], 0
    while len(reqs) < want:
        r = mk(drawn)
        drawn += 1
        if agg_eligible(ix, seg, r):
            reqs.append(r)
    log(f"phase aggregate: {want}/{drawn} requests kernel-raw eligible "
        f"({100.0 * want / drawn:.2f}%); the refused are both-terms-over-"
        f"32,768 pivots (ROADMAP A6)")
    batches = [reqs[i:i + AGG_BATCH] for i in range(0, want, AGG_BATCH)]
    client.ft_aggregate_many("bm25", batches[0][:8])   # set-up: columns

    # the counted aggregate run: counters zeroed just before, read after
    AP.AGG_PATH_STATS.clear()
    IK.LAUNCHES = 0
    GB.LAUNCHES = 0
    results = [client.ft_aggregate_many("bm25", b) for b in batches]
    torch.cuda.synchronize(dev)
    raw_launches, gb_launches = IK.LAUNCHES, GB.LAUNCHES
    stats = dict(AP.AGG_PATH_STATS)
    log(f"phase aggregate: intersect (raw) launches={raw_launches}, "
        f"groupby launches={gb_launches}, path stats={stats}, "
        f"served={want}")
    if raw_launches <= 0 or gb_launches <= 0:
        raise AssertionError("a kernel of the aggregate path never launched")
    if stats != {"device-tail": want}:
        raise AssertionError(f"not every request rode the device tail: "
                             f"{stats} for {want}")
    flat = [r for res in results for r in res]
    for r in flat:
        if len(r.rows) > 10 or r.total < sum(x["n"] for x in r.rows) or any(
                not np.isfinite(x["s"]) for x in r.rows):
            raise AssertionError(f"malformed aggregate result {r}")
    log(f"phase aggregate: requests with rows="
        f"{sum(1 for r in flat if r.rows)}/{len(flat)}, mean total="
        f"{np.mean([r.total for r in flat]):.1f}")

    # every served request recomputed with the plain versions on the card
    with plain_versions():
        plain = [client.ft_aggregate_many("bm25", b) for b in batches]
    for req, k, p in zip(reqs, flat, [r for res in plain for r in res]):
        if k.total != p.total or k.rows != p.rows:
            raise AssertionError(f"aggregate {req.query!r}: kernel "
                                 f"{k.total} {k.rows} vs plain {p.total} "
                                 f"{p.rows}")
    log(f"phase aggregate: all {want} requests kernel == plain (rows, "
        f"totals, order, values exact)")

    grp_ids = seg.strcols["grp"].value_ids.cpu().numpy()
    table = seg.strcols["grp"].table
    price = seg.numerics["price"].values.cpu().numpy()
    for req, r in list(zip(reqs, flat))[:16]:
        total, top = numpy_agg_top(seg, ix, req.query, grp_ids, table, price)
        got = [(x["grp"], x["n"], x["s"]) for x in r.rows]
        if r.total != total or got != [t_[:3] for t_ in top]:
            raise AssertionError(f"aggregate {req.query!r}: {r.total} {got} "
                                 f"!= numpy {total} {top}")
    log("phase aggregate: 16 requests == numpy group-by of the host-copied "
        "postings and columns (total, top-10 grp/n/s)")

    # second shape: STDDEV takes the host finish with sums of squares
    sd_reqs = [mk_sd(i) for i in range(drawn)
               if agg_eligible(ix, seg, mk_sd(i))][:AGG_BATCH]
    AP.AGG_PATH_STATS.clear()
    ksd = client.ft_aggregate_many("bm25", sd_reqs)
    torch.cuda.synchronize(dev)
    if dict(AP.AGG_PATH_STATS) != {"device": len(sd_reqs)}:
        raise AssertionError(f"STDDEV shape: {AP.AGG_PATH_STATS}")
    with plain_versions():
        psd = client.ft_aggregate_many("bm25", sd_reqs)
    for req, k, p in zip(sd_reqs, ksd, psd):
        if k.total != p.total or len(k.rows) != len(p.rows):
            raise AssertionError(f"stddev {req.query!r}: {k.total} vs "
                                 f"{p.total}")
        for a, b in zip(k.rows, p.rows):
            if (a["grp"], a["n"], a["a"]) != (b["grp"], b["n"], b["a"]):
                raise AssertionError(f"stddev {req.query!r}: {a} vs {b}")
            if a["sd"] is None or b["sd"] is None:
                if a["sd"] is not b["sd"]:
                    raise AssertionError(f"stddev {req.query!r}: {a} {b}")
                continue
            # f32 sums of squares in atomic order: hold the centred sum
            # of squares to 1e-5 of the group's sum of squares
            n = b["n"]
            sumsq = (n - 1) * b["sd"] ** 2 + n * b["a"] ** 2
            if abs((n - 1) * (a["sd"] ** 2 - b["sd"] ** 2)) > 1e-5 * sumsq:
                raise AssertionError(f"stddev {req.query!r}: {a} vs {b}")
    log(f"phase aggregate: STDDEV shape, {len(sd_reqs)} requests on the "
        f"host finish: kernel == plain (grp, n, avg exact; stddev on the "
        f"centred sum of squares within 1e-5)")

    # information only: QPS at batch 1024 (host clock, ends in a sync)
    best = None
    for _ in range(2):
        t0 = time.perf_counter()
        for b in batches:
            client.ft_aggregate_many("bm25", b)
        torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    log(f"phase aggregate: qps {want / best:.1f} ({AGG_BATCHES} batches of "
        f"{AGG_BATCH}, best of 2, host clock)")

    # information only: each kernel against its plain version at the
    # bench shapes (every chunk shape of one batch; the JSON line reports
    # the chunk with the most requests)
    with capture_shapes() as cap:
        client.ft_aggregate_many("bm25", batches[0])
    err_raw = err_gb = 0.0
    t = {}
    for name, kern, plain_fn in (
            ("intersect_raw", IK.intersect_batch, IK.intersect_plain),
            ("groupby", GB.groupby_aggregate_batch, GB.groupby_plain)):
        calls = sorted(cap.args["intersect" if name == "intersect_raw"
                                else "groupby"].values(),
                       key=lambda c: -c[0][0].shape[0])
        for ci, (a, k) in enumerate(calls):
            kout, pout = kern(*a, **k), plain_fn(*a, **k)
            lib = None
            if name == "intersect_raw":
                err_raw = max(err_raw, compare_raw(
                    kout, pout, "raw kernel vs plain [aggregate chunk]"))
                b = bound_ms(intersect_bytes(a[0], a[1], k["T"], k["groups"],
                                             k.get("pivot_g", 0), kout))
            else:
                err_gb = max(err_gb, compare_groupby(
                    kout, pout, pout, True,
                    "groupby kernel vs plain [aggregate chunk]"))
                b = bound_ms(nbytes(*a[:2], *kout.values()))
                lib = batch_library_call(*a[:2], a[2], **k)
            del kout, pout
            p1 = time_ms(lambda: plain_fn(*a, **k), 5)
            k1 = time_ms(lambda: kern(*a, **k))
            p2 = time_ms(lambda: plain_fn(*a, **k), 5)
            k2 = time_ms(lambda: kern(*a, **k))
            lib_ms = None if lib is None else time_ms(lib)
            if ci == 0:
                t[name] = (min(k1, k2), min(p1, p2), b, lib_ms)
            log(f"phase aggregate: {name} at a bench chunk shape "
                f"{[tuple(x.shape) for x in a[:2]]} "
                f"{ {kk: v for kk, v in k.items() if kk != 'groups'} }: "
                f"kernel {k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/{p2:.4f} ms "
                f"(device ms, plain/kernel/plain/kernel), bytes bound "
                f"{b:.4f} ms, library call "
                f"{'none' if lib_ms is None else f'{lib_ms:.4f} ms'}")
    check_constant_apply(client, ix, dev)
    phase_agg_profile(ix, batches[0], dev)
    return dict(raw_launches=raw_launches, gb_launches=gb_launches,
                err_raw=err_raw, err_gb=err_gb, raw_ms=t["intersect_raw"],
                gb_ms=t["groupby"])


def check_constant_apply(client, ix, dev):
    """A GROUPBY keyed on an APPLY of constants only (`APPLY "1+2" AS k
    GROUPBY @k REDUCE COUNT 0`, whose compiled expression reads no
    column) through `ft_aggregate_many` and `ft_aggregate`: it must take
    the device GROUPBY, its key column must lie on the card, and the one
    group k = 3 must count every document."""
    seg = ix.segments[0]
    req = rt.AggregateRequest("*").apply("1+2", "k").group_by(
        "@k", ("COUNT", [], "n"))
    AP.AGG_PATH_STATS.clear()
    many = client.ft_aggregate_many("bm25", [req, req])
    one = client.ft_aggregate("bm25", req)
    stats = dict(AP.AGG_PATH_STATS)
    if set(stats) - {"device", "device-tail"} or sum(stats.values()) != 3:
        raise AssertionError(f"constant APPLY key: paths {stats}")
    keys = [ent[3] for ent in seg._gbcols_cache.values()]
    if not keys or any(k.device.type != "cuda" for k in keys):
        raise AssertionError("constant APPLY key: a key column off the "
                             f"card: {[k.device for k in keys]}")
    for r in many + [one]:
        if (len(r.rows) != 1 or float(r.rows[0]["k"]) != 3.0
                or int(float(r.rows[0]["n"])) != seg.n_docs):
            raise AssertionError(f"constant APPLY key: rows {r.rows}")
    log(f"phase aggregate: APPLY \"1+2\" AS k GROUPBY @k REDUCE COUNT 0: "
        f"paths {stats}, key columns on {sorted({str(k.device) for k in keys})}, "
        f"one group k=3 of {seg.n_docs} docs in the batch and the single "
        "call")


def batch_library_call(gslots, vals, n_groups, want_sumsq=True):
    """One PyTorch call computing what the batched group-by kernel (B3)
    computes: a single `index_add_` over every (query, channel, lane)
    into a flat [B * C * (G_pad + 1)] output (C channels a query), its
    indices and sources
    built outside the timed call.  Timed for comparison only; the port
    never calls it."""
    B, S, n = gslots.shape
    G1 = GB._g_pad(n_groups) + 1
    C = GB._channels(S, want_sumsq)
    idx, src = [], []
    c = 0
    for s_ in range(S):
        g = gslots[:, s_]
        gi = torch.where((g >= 0) & (g < G1 - 1), g, G1 - 1).long()
        chans = [(g >= 0).to(torch.float32)]
        if s_ > 0:
            v = torch.where(g >= 0, vals[:, s_ - 1], 0.0)
            chans += [v] + ([v * v] if want_sumsq else [])
        for x in chans:
            q = torch.arange(B, device=g.device)[:, None]
            idx.append(((q * C + c) * G1 + gi).reshape(-1))
            src.append(x.reshape(-1))
            c += 1
    idx, src = torch.cat(idx), torch.cat(src)
    out = torch.zeros(B * C * G1, dtype=torch.float32, device=idx.device)
    return lambda: out.index_add_(0, idx, src)


def single_library_calls(gid, valid, ops, n_groups):
    """One PyTorch call for each mode of the fused single-query kernel,
    its masks, indices and sources built outside the timed call: the
    sums (base count, then per operand count, sum, sumsq) as one
    `index_add_` into [C, G + 1]; min/max as one `scatter_reduce_` amin
    of [v, -v] per operand onto +3.4e38 (min, and -max).  Timed for
    comparison only; the port never calls them."""
    G1 = n_groups + 1
    ok = valid & (gid >= 0) & (gid < n_groups)
    gi = torch.where(ok, gid, n_groups).long()
    idx, src, idx2, src2 = [gi], [ok.to(torch.float32)], [], []
    for j, (v, p) in enumerate(ops):
        okj = ok & p
        gj = torch.where(okj, gid, n_groups).long()
        vm = torch.where(okj, v, 0.0)
        c = 1 + 3 * j
        idx += [gj + c * G1, gj + (c + 1) * G1, gj + (c + 2) * G1]
        src += [okj.to(torch.float32), vm, vm * vm]
        idx2 += [gj + 2 * j * G1, gj + (2 * j + 1) * G1]
        src2 += [vm, -vm]
    idx, src = torch.cat(idx), torch.cat(src)
    out = torch.zeros((1 + 3 * len(ops)) * G1, dtype=torch.float32,
                      device=gid.device)
    idx2, src2 = torch.cat(idx2), torch.cat(src2)
    out2 = torch.full((2 * len(ops) * G1,), GB.BIG, dtype=torch.float32,
                      device=gid.device)
    return (lambda: out.index_add_(0, idx, src),
            lambda: out2.scatter_reduce_(0, idx2, src2, "amin",
                                         include_self=True))


def single_bytes(gid, valid, ops, res) -> int:
    """Bytes the fused kernel must move: the gid and valid columns, each
    operand's present and values (one element for a broadcast constant),
    and the outputs."""
    n = nbytes(gid, valid, *res.values())
    for v, p in ops:
        n += sum(x.element_size() * (x.numel() if x.stride(0) else 1)
                 for x in (v, p))
    return n


def time_single(gid, valid, ops, G, mm, lib, what, integer=True) -> tuple:
    """The fused kernel in one mode against its plain version (checked
    first) and one library call: (kernel ms, plain ms, bound ms,
    library ms, max abs err), device ms, plain/kernel/plain/kernel."""
    kres = GB.groupby_aggregate_multi(gid, valid, ops, G, mm)
    pres = GB.groupby_aggregate_multi_plain(gid, valid, ops, G, mm)
    e = compare_multi(kres, pres, gid, valid, ops, G, integer, what)
    b = bound_ms(single_bytes(gid, valid, ops, kres))
    del kres, pres
    p1 = time_ms(lambda: GB.groupby_aggregate_multi_plain(
        gid, valid, ops, G, mm), 5)
    k1 = time_ms(lambda: GB.groupby_aggregate_multi(gid, valid, ops, G, mm))
    p2 = time_ms(lambda: GB.groupby_aggregate_multi_plain(
        gid, valid, ops, G, mm), 5)
    k2 = time_ms(lambda: GB.groupby_aggregate_multi(gid, valid, ops, G, mm))
    lib_ms = time_ms(lib)
    log(f"phase single-groupby-times: {what} (n={gid.shape[0]}, G={G}, "
        f"ops={len(ops)}, minmax={mm}): kernel {k1:.4f}/{k2:.4f} ms, plain "
        f"{p1:.4f}/{p2:.4f} ms (device ms, plain/kernel/plain/kernel), "
        f"bytes bound {b:.3g} ms, library call {lib_ms:.4f} ms; kernel == "
        f"plain")
    return min(k1, k2), min(p1, p2), b, lib_ms, max(e.values())


def phase_single_groupby_times(ix, dev, windows) -> dict:
    """The fused single-query kernel at the `*` shape (every row of the
    1M-doc segment, G = 1,001 (grp), the price column) in sums-only mode
    (B4's row) and min/max mode (B5's row), and in min/max mode at the
    median and the largest window of the MIN/MAX batch (`windows`, its
    captured arguments); each beside its plain version and one library
    call; and at the `*` shape with every row in one group (G = 1, the
    one-group warp steps).  Returns {name: (kernel ms, plain ms, bound
    ms, library ms, max abs err)}."""
    seg = ix.segments[0]
    ids = seg.strcols["grp"].value_ids
    G = len(seg.strcols["grp"].table) + 1
    gid = torch.where(ids < 0, G - 1, ids)
    valid = torch.arange(seg.n_pad, device=dev) < seg.n_docs
    ops = [(seg.numerics["price"].values, seg.numerics["price"].present)]
    lib_sums, lib_mm = single_library_calls(gid, valid, ops, G)
    out = {"groupby_sums": time_single(gid, valid, ops, G, False, lib_sums,
                                       "the * shape, sums only"),
           "groupby_minmax": time_single(gid, valid, ops, G, True, lib_mm,
                                         "the * shape, min/max")}
    for name, (a, k) in windows.items():
        lib = single_library_calls(a[0], a[1], a[2], a[3])[1]
        out[name] = time_single(*a, True, lib, f"the {name} MIN/MAX window")
    one = torch.zeros_like(gid)
    out["one group"] = time_single(one, valid, ops, 1, False,
                                   single_library_calls(one, valid, ops, 1)[0],
                                   "the * shape, G = 1, sums only")
    return out


def agg_qps(client, batches) -> float:
    """Requests per second over `batches` (host clock, ending in a
    synchronize; best of 2)."""
    best = None
    for _ in range(2):
        t0 = time.perf_counter()
        for b in batches:
            client.ft_aggregate_many("bm25", b)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    return sum(len(b) for b in batches) / best


def multi_calls(client, reqs) -> list:
    """The (args, kwargs) of every `groupby_aggregate_multi` call that
    one more run of the batch `reqs` makes, in window width order."""
    calls = []
    real = GB.groupby_aggregate_multi
    GB.groupby_aggregate_multi = lambda *a, **k: (calls.append((a, k))
                                                  or real(*a, **k))
    try:
        client.ft_aggregate_many("bm25", reqs)
    finally:
        GB.groupby_aggregate_multi = real
    calls.sort(key=lambda c: c[0][0].shape[0])
    return calls


def single_kernels(calls, dev) -> int:
    """Kernel launches that the fused group-by's `calls` need: per
    launcher call (MAX_OPS operands each), from its window by the
    wrapper's geometry."""
    total = 0
    for (gid, _valid, ops, G), k in calls:
        for j0 in range(0, max(len(ops), 1), GB.MAX_OPS):
            C = GB._single_channels(len(ops[j0:j0 + GB.MAX_OPS]),
                                    k["want_minmax"], j0 == 0)
            blocks, _w, _r, shared = GB._single_geometry(
                gid.shape[0], C, GB._g_pad(G), GB._n_sm(dev.index))
            total += GB._single_kernels(blocks, shared)
    return total


def zero_counts():
    AP.AGG_PATH_STATS.clear()
    E.QUERY_PATH_STATS.clear()
    IK.LAUNCHES = IK.PHRASE_LAUNCHES = 0
    GB.LAUNCHES = GB.SINGLE_LAUNCHES = 0


def phase_agg_star(client, ix, dev) -> dict:
    """bench.py's bench_agg_star at batch 64 on the 1M-doc index: the
    window branch (match-all, 1M rows a request; its staged windows would
    exceed _MAX_BATCH_STAGE, so each request makes one call of the fused
    single-query group-by for the base count and the price, which
    launches its row pass and merge pass: 128 launches).  Every request
    must equal a numpy group-by of the host-copied columns.  QPS, memory
    and one batch's host/device split are printed."""
    seg = ix.segments[0]
    base = int(time.time())
    reqs = [star_request(base + i) for i in range(STAR_BATCH)]
    client.ft_aggregate_many("bm25", reqs[:2])        # set-up: columns
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts()
    res = client.ft_aggregate_many("bm25", reqs)
    torch.cuda.synchronize(dev)
    launches = GB.SINGLE_LAUNCHES
    stats = dict(AP.AGG_PATH_STATS)
    calls = multi_calls(client, reqs)
    need = single_kernels(calls, dev)
    log(f"phase aggregate-star: batch {STAR_BATCH}: fused single-query "
        f"calls={len(calls)}, kernel launches={launches} (its calls' "
        f"windows need {need}), batched group-by launches={GB.LAUNCHES}, "
        f"intersect launches={IK.LAUNCHES}, path stats={stats}, "
        f"max_memory_allocated={torch.cuda.max_memory_allocated(dev)}")
    if (len(calls) != STAR_BATCH or launches != need
            or launches != 2 * STAR_BATCH
            or stats != {"device-tail": STAR_BATCH}):
        raise AssertionError(f"star batch: {len(calls)} calls, {launches} "
                             f"single-query launches (need {need}), {stats}")
    del calls
    grp_ids = seg.strcols["grp"].value_ids.cpu().numpy()
    price = seg.numerics["price"].values.cpu().numpy()
    total, top = numpy_agg_top(seg, ix, None, grp_ids,
                               seg.strcols["grp"].table, price,
                               docs=np.arange(seg.n_docs))
    for r in res:
        got = [(x["grp"], x["n"], x["s"]) for x in r.rows]
        if r.total != total or got != [t_[:3] for t_ in top]:
            raise AssertionError(f"star: {r.total} {got} != numpy {total} "
                                 f"{top}")
    log(f"phase aggregate-star: all {STAR_BATCH} requests == numpy group-by "
        f"of the host-copied columns (total {total}, top-10 grp/n/s)")
    qps = agg_qps(client, [reqs])
    log(f"phase aggregate-star: qps {qps:.1f} (batch {STAR_BATCH}, best of "
        f"2, host clock)")
    phase_agg_profile(ix, reqs, dev, "aggregate-star")
    return dict(launches=launches, qps=qps)


def phase_agg_minmax(client, ix, dev) -> dict:
    """The MIN/MAX variant of bench_agg at batch 1024: the window branch
    (MIN/MAX leave the kernel-raw branch), one call of the fused
    single-query group-by a request (1,024 calls; one kernel launch for a
    window of at most 2,048 rows, two above).  Every request must equal
    its plain recomputation
    on the card, 16 must equal numpy, and 16 single `ft_aggregate` calls
    must equal the batch's results.  QPS is printed; the arguments of
    the median and the largest window are returned for the timings."""
    seg = ix.segments[0]
    _mk, _mk_sd, mk_mm = agg_request_fn()
    reqs = [mk_mm(i) for i in range(AGG_BATCH)]
    client.ft_aggregate_many("bm25", reqs[:8])        # set-up
    zero_counts()
    res = client.ft_aggregate_many("bm25", reqs)
    torch.cuda.synchronize(dev)
    launches = GB.SINGLE_LAUNCHES
    stats = dict(AP.AGG_PATH_STATS)
    calls = multi_calls(client, reqs)
    need = single_kernels(calls, dev)
    log(f"phase aggregate-minmax: batch {AGG_BATCH}: fused single-query "
        f"calls={len(calls)}, kernel launches={launches} (its calls' "
        f"windows need {need}), intersect launches={IK.LAUNCHES}, path "
        f"stats={stats}, requests with rows="
        f"{sum(1 for r in res if r.rows)}, mean total="
        f"{np.mean([r.total for r in res]):.1f}")
    if (len(calls) != AGG_BATCH or launches != need
            or stats != {"device-tail": AGG_BATCH}):
        raise AssertionError(f"minmax batch: {len(calls)} calls, {launches} "
                             f"single-query launches (need {need}), {stats}")
    widths = [c[0][0].shape[0] for c in calls]
    windows = {"median": calls[len(calls) // 2], "largest": calls[-1]}
    log(f"phase aggregate-minmax: window widths of the {len(widths)} "
        f"requests: min {widths[0]}, median {widths[len(widths) // 2]}, "
        f"max {widths[-1]}")
    with plain_versions():
        plain = client.ft_aggregate_many("bm25", reqs)
    for req, k, p in zip(reqs, res, plain):
        if k.total != p.total or k.rows != p.rows:
            raise AssertionError(f"minmax {req.query!r}: kernel {k.total} "
                                 f"{k.rows} vs plain {p.total} {p.rows}")
    log(f"phase aggregate-minmax: all {AGG_BATCH} requests kernel == plain "
        f"(rows, totals, order, values exact)")
    grp_ids = seg.strcols["grp"].value_ids.cpu().numpy()
    price = seg.numerics["price"].values.cpu().numpy()
    for req, r in list(zip(reqs, res))[:16]:
        total, top = numpy_agg_top(seg, ix, req.query, grp_ids,
                                   seg.strcols["grp"].table, price)
        got = [(x["grp"], x["n"], x["s"], x["lo"], x["hi"]) for x in r.rows]
        if r.total != total or got != top:
            raise AssertionError(f"minmax {req.query!r}: {r.total} {got} "
                                 f"!= numpy {total} {top}")
    for req, r in list(zip(reqs, res))[:16]:
        one = client.ft_aggregate("bm25", req)
        if one.total != r.total or one.rows != r.rows:
            raise AssertionError(f"ft_aggregate {req.query!r}: {one.total} "
                                 f"{one.rows} vs {r.total} {r.rows}")
    log("phase aggregate-minmax: 16 requests == numpy group-by (total, "
        "top-10 grp/n/s/min/max); 16 single ft_aggregate == "
        "ft_aggregate_many")
    qps = agg_qps(client, [reqs])
    log(f"phase aggregate-minmax: qps {qps:.1f} (batch {AGG_BATCH}, best of "
        f"2, host clock)")
    return dict(launches=launches, qps=qps, windows=windows)


def phase_agg_profile(ix, batch, dev, what="aggregate"):
    """Information only: one aggregate batch's host stages (submit =
    prepare, plan, group, upload and launches; wait = synchronize;
    finish = copies to the host and the per-request finish) and the
    device's busy time over one traced batch."""
    from torch.profiler import ProfilerActivity, profile
    t0 = time.perf_counter()
    h = AP.run_aggregate_many(ix, batch, async_=True)
    t1 = time.perf_counter()
    torch.cuda.synchronize(dev)
    t2 = time.perf_counter()
    h.result()
    t3 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        ts = time.perf_counter()
        AP.run_aggregate_many(ix, batch)
        torch.cuda.synchronize(dev)
        traced = (time.perf_counter() - ts) * 1e3
    busy, kern = device_busy_us(prof, ("intersect_kernel", "groupby_kernel",
                                       "gb_single_kernel", "gb_single_merge"))
    log(f"phase profile: {what} (batch {len(batch)}) host ms: submit "
        f"{(t1 - t0) * 1e3:.3f}, wait {(t2 - t1) * 1e3:.3f}, finish "
        f"{(t3 - t2) * 1e3:.3f}, whole {(t3 - t0) * 1e3:.3f}; traced "
        f"{traced:.3f} ms with device busy {busy:.1f} us (intersect "
        f"{kern['intersect_kernel']:.1f} us, batched groupby "
        f"{kern['groupby_kernel']:.1f} us, fused single-query "
        f"{kern['gb_single_kernel']:.1f} us and its merge "
        f"{kern['gb_single_merge']:.1f} us), idle share "
        f"{1.0 - busy / (traced * 1e3):.4f}")


# --------------------------------------------------------------- phase 6b
CURSOR_COUNT = 3
CURSOR_PAGE = 1000
CURSOR_PAGES = 5
HOST_REQS = 16
#: bench.py's FT.AGGREGATE batch
HOST_BATCH = 1024


def drain(client, res) -> list:
    """Every page of a cursor, the first read's included."""
    pages, cid = [res.rows], res.cursor_id
    while cid:
        rows, cid = client.ft_cursor_read("bm25", cid)
        pages.append(rows)
    return pages


def host_request_fn():
    """Host-pipeline requests over bench.py's 2-term matches: GROUPBY
    @grp with TOLIST and COUNT_DISTINCT of the unsortable @cat, or
    GROUPBY @cat (unsortable: no dictionary column) with TOLIST of @grp;
    and the device request of the same match (COUNT, SUM(@price))."""
    rng = np.random.default_rng(3)
    qt = ["w%06d" % i for i in rng.integers(20, 2000, size=256)]

    def query(i):
        return f"{qt[(2 * i) % 256]} {qt[(2 * i + 1) % 256]}"

    def mk_host(i):
        key, other = ("@cat", "@grp") if i % 4 == 3 else ("@grp", "@cat")
        return (rt.AggregateRequest(query(i))
                .group_by(key, ("COUNT", [], "n"), ("SUM", ["@price"], "s"),
                          ("TOLIST", [other], "l"),
                          ("COUNT_DISTINCT", [other], "dc"))
                .sort_by(("@s", rt.DESC)))

    def mk_dev(i):
        return (rt.AggregateRequest(query(i))
                .group_by("@grp", ("COUNT", [], "n"),
                          ("SUM", ["@price"], "s")))
    return mk_host, mk_dev


def python_groupby(docs, keys, others, price) -> dict:
    """{key: (n, sum, set of the other column)} over the matched docs."""
    out: dict = {}
    for d in docs:
        n, sm, seen = out.get(keys[d], (0, 0.0, set()))
        seen.add(others[d])
        out[keys[d]] = (n + 1, sm + float(price[d]), seen)
    return out


def phase_cursor(client, ix, dev) -> dict:
    """FT.AGGREGATE WITHCURSOR and the host pipeline on the 1M-doc index
    (see the docstring's phase 6b)."""
    t_phase = time.perf_counter()
    seg = ix.segments[0]
    mk, _mk_sd, _mk_mm = agg_request_fn()
    # bench.py's request, paged 3 rows at a time: the device GROUPBY runs
    # materialized (the fused single-query group-by), then pages
    launches = 0
    for i in range(4):
        zero_counts()
        res = client.ft_aggregate("bm25", mk(i).cursor(CURSOR_COUNT))
        pages = drain(client, res)
        launches += GB.SINGLE_LAUNCHES
        plain = client.ft_aggregate("bm25", mk(i))
        if (res.total != plain.total or [r for p in pages for r in p]
                != plain.rows or any(len(p) > CURSOR_COUNT for p in pages)):
            raise AssertionError(f"cursor {mk(i).query!r}: pages {pages} "
                                 f"vs {plain.total} {plain.rows}")
    if launches == 0:
        raise AssertionError("cursor: the fused group-by never launched")
    log(f"phase cursor: bench request WITHCURSOR COUNT {CURSOR_COUNT} x4: "
        f"pages == ft_aggregate rows; fused single-query group-by launches "
        f"{launches} in the cursor runs")

    # '*' LOAD @price: streamed, the buffer holds a chunk
    price = seg.numerics["price"].values.cpu().numpy()
    t0 = time.perf_counter()
    res = client.ft_aggregate("bm25", rt.AggregateRequest("*")
                              .load("@price").cursor(CURSOR_PAGE))
    torch.cuda.synchronize(dev)
    first_s = time.perf_counter() - t0
    buffered = len(client.cursors._cursors[res.cursor_id].rows)
    if res.total != N_DOCS or buffered > 2 * AP._STREAM_CHUNK:
        raise AssertionError(f"cursor '*': total {res.total}, buffer "
                             f"{buffered}")
    rows, cid = list(res.rows), res.cursor_id
    for _ in range(CURSOR_PAGES):
        page, cid = client.ft_cursor_read("bm25", cid)
        if len(page) != CURSOR_PAGE or not cid:
            raise AssertionError(f"cursor '*': page of {len(page)}, id {cid}")
        rows += page
    got = np.array([r["price"] for r in rows])
    if not np.array_equal(got, price[:len(rows)].astype(np.float64)):
        raise AssertionError("cursor '*': prices differ from the column")
    if not client.ft_cursor_del("bm25", cid):
        raise AssertionError("cursor '*': FT.CURSOR DEL found no cursor")
    try:
        client.ft_cursor_read("bm25", cid)
    except rt.utils.errors.CursorNotFound:
        pass
    else:
        raise AssertionError("cursor '*': read after DEL succeeded")
    log(f"phase cursor: '*' LOAD @price CURSOR {CURSOR_PAGE}: total "
        f"{res.total:,}, buffer after the first read {buffered} rows "
        f"(chunk {AP._STREAM_CHUNK}); first read {first_s:.3f}s; "
        f"{CURSOR_PAGES} pages == column; DEL ok")

    # host-pipeline requests against a Python group-by of the host copies
    mk_host, mk_dev = host_request_fn()
    grp_ids = seg.strcols["grp"].value_ids.cpu().numpy()
    table = list(seg.strcols["grp"].table) + [None]
    grp = np.array(table, dtype=object)[np.where(grp_ids >= 0, grp_ids,
                                                  len(table) - 1)]
    didx = np.array([int(ix.doctable.get(int(g)).key[1:])
                     for g in seg.gids_np[:seg.n_docs]])
    cats = np.array(["cat%02d" % (i % 16) for i in range(16)],
                    dtype=object)[didx % 16]
    zero_counts()
    t0 = time.perf_counter()
    host = [client.ft_aggregate("bm25", mk_host(i))
            for i in range(HOST_REQS)]
    host_s = time.perf_counter() - t0
    stats = dict(AP.AGG_PATH_STATS)
    if stats != {"host": HOST_REQS}:
        raise AssertionError(f"host requests: path stats {stats}")
    # bench.py's batch size through ft_aggregate_many: the requests
    # repeat every 128, the first HOST_REQS are held against the Python
    # group-by below through the single calls
    zero_counts()
    t0 = time.perf_counter()
    batch = client.ft_aggregate_many(
        "bm25", [mk_host(i) for i in range(HOST_BATCH)])
    batch_s = time.perf_counter() - t0
    stats = dict(AP.AGG_PATH_STATS)
    if stats != {"host": HOST_BATCH}:
        raise AssertionError(f"host batch: path stats {stats}")
    for i, r in enumerate(batch):
        want = host[i] if i < HOST_REQS else batch[i % 128]
        if r.total != want.total or r.rows != want.rows:
            raise AssertionError(f"host batch: request {i} differs")
    n_rows = 0
    for i, r in enumerate(host):
        docs = numpy_and2_docs(seg, ix, mk_host(i).query)
        by_cat = i % 4 == 3
        keys, others = (cats, grp) if by_cat else (grp, cats)
        want = python_groupby(docs, keys, others, price)
        got = {x["cat" if by_cat else "grp"]: x for x in r.rows}
        if r.total != len(docs) or set(got) != set(want):
            raise AssertionError(f"host {mk_host(i).query!r}: total "
                                 f"{r.total} vs {len(docs)}, groups")
        for key, (n, sm, seen) in want.items():
            x = got[key]
            if (x["n"] != n or x["s"] != sm or x["dc"] != len(seen)
                    or sorted(x["l"]) != sorted(seen)):
                raise AssertionError(f"host {mk_host(i).query!r} {key}: "
                                     f"{x} vs {(n, sm, sorted(seen))}")
        sums = [x["s"] for x in r.rows]
        if sums != sorted(sums, reverse=True):
            raise AssertionError(f"host {mk_host(i).query!r}: not sorted")
        n_rows += len(r.rows)
        if not by_cat:
            dev_rows = {x["grp"]: x for x in client.ft_aggregate(
                "bm25", mk_dev(i)).rows}
            for key, x in got.items():
                d = dev_rows[key]
                if d["n"] != x["n"] or not abs(d["s"] - x["s"]) <= (
                        1e-5 * x["s"]):
                    raise AssertionError(f"host {mk_host(i).query!r} {key}:"
                                         f" device {d} vs host {x}")
    log(f"phase cursor: {HOST_REQS} host-pipeline requests ({n_rows} "
        f"groups; GROUPBY @grp with TOLIST/COUNT_DISTINCT of @cat, every "
        f"4th keyed on the unsortable @cat) == Python group-by of the host "
        f"copies; COUNT/SUM == the device path's (within 1e-5 of the "
        f"group's sum of |price|); {host_s:.3f}s for the {HOST_REQS}; "
        f"ft_aggregate_many of {HOST_BATCH} == single calls, path stats "
        f"{stats}, {batch_s:.3f}s = {HOST_BATCH / batch_s:.1f} requests/s")

    # a mixed batch: device-tail and host requests, request order kept
    reqs = [mk(i) if i % 2 == 0 else mk_host(i) for i in range(8)]
    zero_counts()
    mixed = client.ft_aggregate_many("bm25", reqs)
    stats = dict(AP.AGG_PATH_STATS)
    if stats != {"device-tail": 4, "host": 4}:
        raise AssertionError(f"mixed batch: path stats {stats}")
    for i, r in enumerate(mixed):
        one = client.ft_aggregate("bm25", reqs[i])
        if (r.total != one.total or len(r.rows) != len(one.rows)
                or not all(same_agg_row(x, y, tail=i % 2 == 0)
                           for x, y in zip(r.rows, one.rows))):
            raise AssertionError(f"mixed batch: request {i}: {r.total} "
                                 f"{r.rows} vs single {one.total} "
                                 f"{one.rows}")
    log(f"phase cursor: mixed ft_aggregate_many batch of 8: path stats "
        f"{stats}, each result's rows == its single call's")

    # a full drain of '*' LOAD @price: every page timed
    t0 = time.perf_counter()
    pages = drain(client, client.ft_aggregate(
        "bm25", rt.AggregateRequest("*").load("@price").cursor(CURSOR_PAGE)))
    drain_s = time.perf_counter() - t0
    got = np.fromiter((r["price"] for p in pages for r in p), np.float64)
    if (len(pages) != N_DOCS // CURSOR_PAGE
            or any(len(p) != CURSOR_PAGE for p in pages)
            or not np.array_equal(got, price[:N_DOCS].astype(np.float64))):
        raise AssertionError(f"cursor '*' drain: {len(pages)} pages, "
                             f"{len(got)} rows, prices differ from the "
                             f"column")
    log(f"phase cursor: '*' LOAD @price CURSOR {CURSOR_PAGE} drained: "
        f"{len(pages)} pages == column in {drain_s:.3f}s = "
        f"{len(pages) / drain_s:.1f} pages/s; phase "
        f"{time.perf_counter() - t_phase:.1f}s")
    return dict(launches=launches, pages_per_s=len(pages) / drain_s,
                host_qps=HOST_BATCH / batch_s)


def same_agg_row(x: dict, y: dict, tail: bool) -> bool:
    """Whether two result rows are equal: every value exactly, except,
    where `tail` (bench.py's request on the device tail), SUM within
    1e-5 of the group's sum of |price| (prices are positive: the SUM)
    and AVG within that over COUNT."""
    if not tail:
        return x == y
    tol = 1e-5 * abs(y["s"])
    return (x.keys() == y.keys() and x["grp"] == y["grp"]
            and x["n"] == y["n"] and abs(x["s"] - y["s"]) <= tol
            and abs(x["a"] - y["a"]) <= tol / y["n"])


# ---------------------------------------------------------------- phase 7
#: bench.py's knn section: 1M x 128 f32 rows, L2, k = 10, batches of 2048
KNN_N, KNN_D, KNN_K, KNN_B = 1_000_000, 128, 10, 2048
#: query chunks scanned (bench.py scans 48; 4 hold the checks and times)
KNN_CHUNKS = 4
#: bench.py's filtered-KNN section: 500k x 384 unit vectors, COSINE
FKNN_N, FKNN_D, FKNN_B, FKNN_K = 500_000, 384, 2048, 25
#: batches of the pipelined QPS loop (the hoisted and knn-row families
#: take about 5 s a batch on the host)
FKNN_PIPE = 2
FKNN_WORDS = ["algebra", "graph", "neural", "quantum", "protein", "market",
              "vision", "speech", "logic", "random"]
#: H100 SXM data-sheet peaks (dense): bf16 tensor cores, f32 outside them
BF16_FLOPS = 989e12
F32_FLOPS = 67e12


def bound2(n_bytes: float, n_ops: float, peak: float) -> tuple:
    """(bound ms, "bytes" or "operations"): the larger of the bytes over
    the memory rate and the operations over their type's peak."""
    b, o = n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / peak * 1e3
    return (b, "bytes") if b >= o else (o, "operations")


def vector_parts(vecs, scan, sq, Q, k, metric, valid2d, calls) -> list:
    """Device ms of each part of one `knn_batch_masked` call (two-phase:
    bf16 scan copy, f32 rescore) at these inputs, each beside its bound:
    the GEMM (`_scores`, f32 out), the metric epilogue, the mask, the
    candidate top-C (`_cand_top`), the f32 rescore and the final top-k.
    `calls` is how many such calls a batch makes."""
    B, N, d = Q.shape[0], vecs.shape[0], vecs.shape[1]
    C = V._cand_k(N, k)
    dots = V._scores(scan, Q)
    qf = Q.float()
    qn = torch.sqrt((qf * qf).sum(1))
    vn = torch.sqrt(torch.clamp(sq, min=1e-30))

    def epilogue():
        if metric == "L2":
            return sq[None, :] - 2.0 * dots + (qf * qf).sum(1)[:, None]
        return 1.0 - dots / (vn[None, :] * torch.clamp(qn[:, None],
                                                       min=1e-30))

    dist = epilogue()
    dm = torch.where(valid2d, dist, V.BIG)
    avals, aidx = V._cand_top(-dm, C)
    dr = V._rescore(vecs, sq, Q, aidx, metric)
    f4 = 4 * B * N
    parts = [
        ("GEMM (bf16 in, f32 out)", lambda: V._scores(scan, Q),
         bound2(nbytes(scan, Q) + f4, 2.0 * B * N * d, BF16_FLOPS)),
        (f"{metric} epilogue", epilogue,
         bound2(2 * f4 + nbytes(sq, Q), 3.0 * B * N, F32_FLOPS)),
        ("mask", lambda: torch.where(valid2d, dist, V.BIG),
         bound2(2 * f4 + nbytes(valid2d), B * N, F32_FLOPS)),
        (f"_cand_top (C={C})", lambda: V._cand_top(-dm, C),
         bound2(f4 + 12 * B * C, B * N, F32_FLOPS)),
        ("rescore", lambda: V._rescore(vecs, sq, Q, aidx, metric),
         bound2(4 * B * C * d + nbytes(Q, aidx) + 8 * B * C,
                2.0 * B * C * d, F32_FLOPS)),
        (f"final top-k (k={k})", lambda: T.fast_top_k(-dr, k),
         bound2(nbytes(dr) + 12 * B * k, B * C, F32_FLOPS))]
    out = []
    for name, fn, (b, by) in parts:
        ms = time_ms(fn, iters=5)
        out.append({"part": name, "ms": ms, "bound_ms": b, "bound_by": by,
                    "calls": calls})
    del dots, dist, dm, avals, aidx, dr
    return out


def log_parts(what: str, parts: list) -> None:
    for p in parts:
        log(f"phase vector: {what} part {p['part']}: {p['ms']:.4f} ms "
            f"against {p['bound_ms']:.4f} ms ({p['bound_by']}), "
            f"{p['calls']} calls a batch")
    log(f"phase vector: {what} parts json " + json.dumps(parts))


def phase_knn_ops(dev) -> list:
    """bench.py's knn shape at the op level: `knn_scan_batches` over
    KNN_CHUNKS chunks of 2048 queries (f32 L2, bf16 scan copy, k = 10).
    Recall@10 of 256 queries against exact float64 distances on the card
    must reach 0.99 (the JAX package's contract), and every returned
    distance must be within 1e-4 relative of its float64 value."""
    from redisearch_tpu_torch.index.segment import bf16_scan_copy
    g = torch.Generator(device=dev).manual_seed(0)
    vecs = torch.randn(KNN_N, KNN_D, generator=g, device=dev)
    Q = torch.randn(KNN_CHUNKS, KNN_B, KNN_D, generator=g, device=dev)
    sq = (vecs.double() ** 2).sum(1).float()
    scan = bf16_scan_copy(vecs)
    present = torch.ones(KNN_N, dtype=torch.bool, device=dev)
    V.knn_scan_batches(vecs, sq, present, Q[:1], KNN_K, "L2",
                       scan_vecs=scan)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    dists, idx = V.knn_scan_batches(vecs, sq, present, Q, KNN_K, "L2",
                                    scan_vecs=scan)
    torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) - base
    q64, v64 = Q[0, :256].double(), vecs.double()
    d64 = ((v64 * v64).sum(1)[None, :] - 2.0 * (q64 @ v64.t())
           + (q64 * q64).sum(1)[:, None])
    truth = torch.topk(d64, KNN_K, dim=1, largest=False).indices
    del d64, v64
    recall = float((idx[0, :256, :, None] == truth[:, None, :]).any(-1)
                   .double().mean())
    g64 = ((vecs[idx.long()].double() - Q[:, :, None, :].double()) ** 2
           ).sum(-1)
    rel = float(((dists.double() - g64).abs()
                 / g64.abs().clamp(min=1e-30)).max())
    log(f"phase vector: knn ops {KNN_CHUNKS} chunks x {KNN_B} queries over "
        f"{KNN_N:,} x {KNN_D} f32 L2 (bf16 scan copy), k={KNN_K}: "
        f"{KNN_CHUNKS * KNN_B / dt:.1f} qps (host clock, one call), peak "
        f"transient {peak / 2**30:.2f} GiB; recall@10 of 256 queries "
        f"against float64 {recall:.4f}; max relative distance error "
        f"{rel:.3e}")
    if recall < 0.99 or not rel <= 1e-4:
        raise AssertionError(f"knn ops: recall {recall}, rel err {rel}")
    parts = vector_parts(vecs, scan, sq, Q[0], KNN_K, "L2",
                         present[None, :], KNN_CHUNKS)
    log_parts(f"knn ops ({KNN_N:,} x {KNN_D}, B {KNN_B})", parts)
    del vecs, Q, scan, dists, idx, g64
    torch.cuda.empty_cache()
    return parts


def fknn_corpus(n: int, dim: int, seed: int = 0):
    """bench.py's arxiv-shaped filtered-KNN corpus (bench_filtered_knn):
    titles of 3 of 10 words, year 1990 + i % 35, cat c{i % 20}, unit
    normal vectors, from `seed`, drawn in bulk; and 512 query vectors."""
    rng = np.random.default_rng(seed)
    words = np.array(FKNN_WORDS)
    vecs = rng.normal(size=(n, dim)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    tidx = rng.integers(0, 10, size=(n, 3))
    titles = [" ".join(t) for t in words[tidx]]
    docs = [(f"p{i}", {"title": titles[i], "year": int(1990 + i % 35),
                       "cat": f"c{i % 20}", "emb": vecs[i]})
            for i in range(n)]
    qvecs = rng.normal(size=(512, dim)).astype(np.float32)
    return docs, vecs, tidx, qvecs


def fknn_families():
    """(query fn, route, host filter fn) per family: bench.py's fulltext,
    numeric and tag families, pure KNN, and a check-only narrow family.
    At 500k docs every leaf of the narrow family has a 32,768-lane
    window, which the planner sends to BATCHES; HYBRID_POLICY ADHOC_BF
    keeps it on the knn-row executor."""
    W = FKNN_WORDS
    return {
        "fulltext": (lambda i: f"(@title:{W[i % 10]})"
                     "=>[KNN 25 @emb $b EF_RUNTIME 64]", "knn-batches",
                     lambda i, tidx, year, cat: (tidx == i % 10).any(1)),
        "numeric": (lambda i: f"(@year:[{1990 + i % 30} {1995 + i % 30}])"
                    "=>[KNN 25 @emb $b EF_RUNTIME 64]", "knn-dense",
                    lambda i, tidx, year, cat: (year >= 1990 + i % 30)
                    & (year <= 1995 + i % 30)),
        "tag": (lambda i: f"(@cat:{{c{i % 20}}})"
                "=>[KNN 25 @emb $b EF_RUNTIME 64]", "knn-dense",
                lambda i, tidx, year, cat: cat == i % 20),
        "pure": (lambda i: "*=>[KNN 25 @emb $b]", "knn-pure",
                 lambda i, tidx, year, cat: np.ones(len(year), bool)),
        "narrow": (lambda i: f"(@title:{W[i % 10]} "
                   f"@year:[{1990 + i % 35} {1990 + i % 35}])"
                   "=>[KNN 25 @emb $b HYBRID_POLICY ADHOC_BF]", "knn-row",
                   lambda i, tidx, year, cat: (tidx == i % 10).any(1)
                   & (year == 1990 + i % 35)),
    }


def check_fknn(res, qs, qvecs, v64, ffn, what) -> float:
    """Every hit passes its filter, each distance within 1e-5 of its
    float64 value, and recall@25 of the batch against an exact float64
    top-25 over the filter's docs, computed on the card.  The filters are
    evaluated on the host from the corpus's own arrays, once per query
    string.  Returns the recall."""
    masks_by_q: dict = {}

    def fmask(r):
        m = masks_by_q.get(qs[r])
        if m is None:
            m = masks_by_q[qs[r]] = ffn(r)
        return m

    hit_sum = live_sum = 0
    for c0 in range(0, len(res), 256):
        rows = range(c0, min(len(res), c0 + 256))
        q = torch.from_numpy(qvecs[[r % 512 for r in rows]]).to(
            v64.device).double()
        qn = q / q.norm(dim=1, keepdim=True)
        d64 = 1.0 - qn @ v64.t()                       # unit rows
        masks = torch.from_numpy(np.stack([fmask(r) for r in rows])).to(
            v64.device)
        d64 = torch.where(masks, d64, float("inf"))
        n_valid = masks.sum(1)
        truth = torch.topk(d64, FKNN_K, dim=1, largest=False).indices.cpu()
        d64 = d64.cpu().numpy()
        for j, r in enumerate(rows):
            keys = [int(h.key[1:]) for h in res[r].hits]
            m = fmask(r)
            if not all(m[i] for i in keys):
                raise AssertionError(f"{what}: query {r} returned a doc "
                                     "that fails its filter")
            got = np.array([h.vector_distance for h in res[r].hits])
            err = np.abs(got - d64[j, keys]).max() if keys else 0.0
            if not err <= 1e-5:
                raise AssertionError(f"{what}: query {r} distance error "
                                     f"{err}")
            want = set(truth[j, :min(FKNN_K, int(n_valid[j]))].tolist())
            hit_sum += len(set(keys) & want)
            live_sum += len(want)
    return hit_sum / max(live_sum, 1)


def same_knn_hits(a, b, what, tol=1e-5):
    """Two KNN results agree: as many hits, distances within tol lane
    for lane, and equal keys wherever neighbouring distances differ by
    more than tol.  (Totals differ by design: a pure KNN batch counts
    every live vector, a single search at most k, in both packages.)"""
    if len(a.hits) != len(b.hits):
        raise AssertionError(f"{what}: hits {len(a.hits)} / "
                             f"{len(b.hits)}")
    da = np.array([h.vector_distance for h in a.hits])
    db = np.array([h.vector_distance for h in b.hits])
    if len(da) and not np.abs(da - db).max() <= tol:
        raise AssertionError(f"{what}: distances differ")
    for j in range(len(da)):
        near = ((j > 0 and da[j] - da[j - 1] <= tol)
                or (j + 1 < len(da) and da[j + 1] - da[j] <= tol))
        if not near and a.hits[j].key != b.hits[j].key:
            raise AssertionError(f"{what}: lane {j} key differs")


def phase_fknn(dev) -> dict:
    """bench.py's filtered-KNN corpus end to end (see the docstring's
    phase 7)."""
    from torch.profiler import ProfilerActivity, profile
    t0 = time.perf_counter()
    docs, vecs, tidx, qvecs = fknn_corpus(FKNN_N, FKNN_D)
    year = 1990 + np.arange(FKNN_N) % 35
    cat = np.arange(FKNN_N) % 20
    t1 = time.perf_counter()
    client = rt.Client(device=dev)
    ix = client.ft_create("arxivb", [
        rt.Field("title", rt.FieldType.TEXT),
        rt.Field("year", rt.FieldType.NUMERIC, sortable=True),
        rt.Field("cat", rt.FieldType.TAG),
        rt.Field("emb", rt.FieldType.VECTOR, vector=rt.VectorParams(
            dim=FKNN_D, metric="COSINE"))])
    ix.add_documents(docs)
    torch.cuda.synchronize(dev)
    t2 = time.perf_counter()
    del docs
    seg = ix.segments[0]
    log(f"phase vector: fknn corpus {FKNN_N:,} x {FKNN_D} built in "
        f"{t1 - t0:.1f}s, ingest (ft_create + add_documents) "
        f"{t2 - t1:.1f}s, segment {seg.memory_bytes() / 2**30:.2f} GiB")
    v64 = torch.from_numpy(vecs).to(dev).double()
    out = {}
    for fam, (qfn, route, ffn) in fknn_families().items():
        qs = [qfn(i) for i in range(FKNN_B)]
        params = [{"b": qvecs[i % 512]} for i in range(FKNN_B)]
        E.QUERY_PATH_STATS.clear()
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        ts = time.perf_counter()
        res = client.ft_search_many("arxivb", qs, params=params, k=FKNN_K)
        torch.cuda.synchronize(dev)
        first = time.perf_counter() - ts
        peak = torch.cuda.max_memory_allocated(dev) - base
        if E.QUERY_PATH_STATS != {route: FKNN_B}:
            raise AssertionError(f"fknn {fam}: routes "
                                 f"{E.QUERY_PATH_STATS}, want {route}")
        ts = time.perf_counter()
        rec = check_fknn(res, qs, qvecs, v64,
                         lambda r: ffn(r, tidx, year, cat), f"fknn {fam}")
        if rec < 0.99:
            raise AssertionError(f"fknn {fam}: recall@25 {rec}")
        check_s = time.perf_counter() - ts
        ts = time.perf_counter()
        for i in range(0, FKNN_B, FKNN_B // 64):
            one = client.ft_search("arxivb", qs[i], params=params[i],
                                   num=FKNN_K)
            same_knn_hits(res[i], one, f"fknn {fam} single {i}")
        single_s = time.perf_counter() - ts
        # the per-query executors check an eighth of the batch
        nt = FKNN_B // 8 if route in ("knn-batches", "knn-row") else FKNN_B
        prev = torch.get_float32_matmul_precision()
        torch.backends.cuda.matmul.allow_tf32 = True    # the caller's
        tf = client.ft_search_many("arxivb", qs[:nt], params=params[:nt],
                                   k=FKNN_K)
        kept = torch.get_float32_matmul_precision()
        torch.set_float32_matmul_precision(prev)
        if kept != "high":
            raise AssertionError(f"fknn {fam}: the caller's TF32 setting "
                                 f"became {kept!r}")
        for i, (a, b) in enumerate(zip(res, tf)):
            if ([h.key for h in a.hits] != [h.key for h in b.hits]
                    or [h.vector_distance for h in a.hits]
                    != [h.vector_distance for h in b.hits]):
                raise AssertionError(f"fknn {fam}: query {i} differs with "
                                     "TF32 on")
        ts = time.perf_counter()
        client.ft_search_many("arxivb", qs, params=params, k=FKNN_K)
        torch.cuda.synchronize(dev)
        seq = time.perf_counter() - ts
        opts = E.QueryOptions(k=FKNN_K)
        ts = time.perf_counter()
        pending = []
        for _ in range(FKNN_PIPE):
            cqs = [ix.prepare(q, p, opts, 2) for q, p in zip(qs, params)]
            pending.append(E.execute_batch(cqs, seg, FKNN_K, async_=True))
            if len(pending) > 2:
                pending.pop(0).result()
        for h in pending:
            h.result()
        piped = time.perf_counter() - ts
        # the per-query executors launch some 10^5 ops a batch, whose
        # trace takes minutes to read back: they trace an eighth of one
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            ts = time.perf_counter()
            client.ft_search_many("arxivb", qs[:nt], params=params[:nt],
                                  k=FKNN_K)
            torch.cuda.synchronize(dev)
            traced = (time.perf_counter() - ts) * 1e3
        ts = time.perf_counter()
        busy, _ = device_busy_us(prof, ())
        read_s = time.perf_counter() - ts
        out[fam] = {"qps": FKNN_B / seq,
                    "piped_qps": FKNN_PIPE * FKNN_B / piped,
                    "recall": rec, "peak": peak}
        log(f"phase vector: fknn {fam} ({route}, batch {FKNN_B}, k "
            f"{FKNN_K}): recall@25 {rec:.4f}, 64 single ft_search equal, "
            f"TF32-on batch equal; qps {FKNN_B / seq:.1f} (one batch "
            f"after the checks), pipelined "
            f"{FKNN_PIPE * FKNN_B / piped:.1f} ({FKNN_PIPE} batches, depth "
            "2, no hits built); "
            f"first batch {first:.3f}s, checks {check_s:.1f}s, 64 single "
            f"calls {single_s:.1f}s, peak transient "
            f"{peak / 2**30:.2f} GiB; traced batch of {nt} {traced:.3f} ms "
            f"with device busy {busy:.1f} us, idle share "
            f"{1.0 - busy / (traced * 1e3):.4f} (trace read in "
            f"{read_s:.1f}s)")
    if torch.get_float32_matmul_precision() != "highest":
        raise AssertionError("the caller's matmul precision was not kept")
    col = seg.vectors["emb"]
    qs = torch.from_numpy(qvecs[:512]).to(dev)
    qs = torch.cat([qs] * (E._knn_chunk(seg.n_pad) // 512))
    parts = vector_parts(col.vecs, col.scan_vecs, col.sq_norms, qs,
                         FKNN_K, "COSINE", (col.present & seg.alive)[None],
                         -(-FKNN_B // qs.shape[0]))
    log_parts(f"fknn pure ({FKNN_N:,} x {FKNN_D}, chunk {qs.shape[0]})",
              parts)
    log("phase vector: fknn path stats " + json.dumps(
        {fam: fknn_families()[fam][1] for fam in out}))
    return {"families": out, "parts": parts,
            "index": (client, ix, v64, qvecs)}


def phase_vector(dev) -> dict:
    t0 = time.perf_counter()
    ops = phase_knn_ops(dev)
    fk = phase_fknn(dev)
    log(f"phase vector: done in {time.perf_counter() - t0:.1f}s")
    return {"ops": ops, **fk}


# --------------------------------------------------------------- phase 7b
#: bench.py's bench_hybrid: batch 1024, window 20, limit 10, 4 rounds
HYB_B, HYB_W, HYB_LIMIT, HYB_ROUNDS = 1024, 20, 10, 4


def hybrid_queries(it: int, combine: str) -> list:
    """bench.py's bench_hybrid round `it`: a single title word and one of
    512 query vectors (seed 5) per query."""
    qvecs = np.random.default_rng(5).normal(size=(512, FKNN_D)).astype(
        np.float32)
    return [rt.HybridQuery(
        search=FKNN_WORDS[(it * HYB_B + i) % 10], vsim_field="emb",
        vsim_vector=qvecs[(it * HYB_B + i) % 512], combine=combine,
        window=HYB_W, limit=HYB_LIMIT) for i in range(HYB_B)]


def same_fusion(a, b, what):
    """Two fused row lists: equal keys, order and fields, floats within
    1e-6 (the vectorized fusion takes 1/(1+dist) in f32, the hit-list
    fusion in Python floats)."""
    if [r["__key"] for r in a] != [r["__key"] for r in b]:
        raise AssertionError(f"{what}: keys differ")
    for ra, rb in zip(a, b):
        if list(ra) != list(rb):
            raise AssertionError(f"{what}: fields differ")
        for k, v in rb.items():
            if isinstance(v, float) and not abs(ra[k] - v) <= 1e-6:
                raise AssertionError(f"{what}: {k} {ra[k]} vs {v}")


def phase_hybrid(dev, ctx) -> dict:
    """FT.HYBRID and the rounds API on the 500k x 384 index (see the
    docstring's phase 7b)."""
    from dataclasses import replace

    from torch.profiler import ProfilerActivity, profile

    from redisearch_tpu_torch.aux import hybrid as H
    t_phase = time.perf_counter()
    client, ix, v64, fqvecs = ctx
    seg = ix.segments[0]
    out = {}
    for combine in ("RRF", "LINEAR"):
        hqs = hybrid_queries(0, combine)
        E.QUERY_PATH_STATS.clear()
        t0 = time.perf_counter()
        fast = H.run_hybrid_many(ix, hqs)
        batch_s = time.perf_counter() - t0
        routes = dict(E.QUERY_PATH_STATS)
        slow = H._run_hybrid_hits(ix, hqs, None)
        for i, (a, b) in enumerate(zip(fast, slow)):
            same_fusion(a, b, f"hybrid {combine} query {i}")
        if sum(routes.values()) != 2 * HYB_B or not all(
                len(r) == HYB_LIMIT for r in fast):
            raise AssertionError(f"hybrid {combine}: routes {routes}, "
                                 f"{[len(r) for r in fast][:8]} rows")
        out[combine] = {"batch_s": batch_s, "routes": routes}
        log(f"phase hybrid: {combine} batch {HYB_B} (window {HYB_W}, limit "
            f"{HYB_LIMIT}): run_hybrid_many == _run_hybrid_hits for every "
            f"query; routes of both branches {routes}; one batch "
            f"{batch_s:.3f}s")

    # the KNN branch as the batch runs it, and where one batch's time goes
    hqs = hybrid_queries(1, "RRF")
    t = [time.perf_counter()]
    cqs = H._branch_queries(ix, hqs)
    t.append(time.perf_counter())
    subs = E._prep_subs(cqs, seg, HYB_W)
    t.append(time.perf_counter())
    parts, branch_ms = [], {}
    for idxs, entry, sa, rows in subs:
        ts = time.perf_counter()
        parts.append((idxs, entry.run(sa, rows)))
        torch.cuda.synchronize(dev)
        br = "text" if idxs[0] % 2 == 0 else "knn"
        key = f"{br}:{entry.path}"
        branch_ms[key] = branch_ms.get(key, 0.0) + (
            time.perf_counter() - ts) * 1e3
    t.append(time.perf_counter())
    results = E._BatchHandle(parts, len(cqs), cqs=cqs, seg=seg,
                             k=HYB_W).result()
    t.append(time.perf_counter())
    fused_only = H._hybrid_finish(ix, [replace(h, limit=0) for h in hqs],
                                  None, [results], HYB_W)
    t.append(time.perf_counter())
    rows = H._hybrid_finish(ix, hqs, None, [results], HYB_W)
    t.append(time.perf_counter())
    if any(fused_only) or rows != H.run_hybrid_many(ix, hqs):
        raise AssertionError("hybrid: the staged batch differs from "
                             "run_hybrid_many")
    ms = [(b - a) * 1e3 for a, b in zip(t, t[1:])]
    q = torch.from_numpy(np.stack([h.vsim_vector for h in hqs])).to(
        dev).double()
    d64 = 1.0 - (q / q.norm(dim=1, keepdim=True)) @ v64.t()
    truth = torch.topk(d64, HYB_W, dim=1, largest=False).indices.cpu()
    del d64
    hit = 0
    for i in range(HYB_B):
        kr = results[2 * i + 1]
        got = kr.local_idx[kr.knn_dists < 3.3e38]
        hit += len(set(got.tolist()) & set(truth[i].tolist()))
    recall = hit / (HYB_B * HYB_W)
    if recall < 0.99:
        raise AssertionError(f"hybrid: KNN branch recall@{HYB_W} {recall}")
    nt = HYB_B // 8
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        ts = time.perf_counter()
        H.run_hybrid_many(ix, hqs[:nt])
        torch.cuda.synchronize(dev)
        traced = (time.perf_counter() - ts) * 1e3
    busy, _ = device_busy_us(prof, ())
    log(f"phase hybrid: KNN branch recall@{HYB_W} {recall:.4f} against an "
        f"exact float64 top-{HYB_W} on the card; one RRF batch of {HYB_B}, "
        f"host ms: prepare {ms[0]:.3f}, bind {ms[1]:.3f}, branch groups "
        f"(launch + synchronize) {ms[2]:.3f} "
        + json.dumps({k: round(v, 3) for k, v in branch_ms.items()})
        + f", d2h and results {ms[3]:.3f}, fusion {ms[4]:.3f}, rows "
        f"{ms[5] - ms[4]:.3f}; traced run_hybrid_many of {nt} "
        f"{traced:.3f} ms with device busy {busy:.1f} us, idle share "
        f"{1.0 - busy / (traced * 1e3):.4f}")

    # rounds: run_hybrid_rounds == run_hybrid_many per round
    rounds = [hybrid_queries(it, "RRF") for it in range(HYB_ROUNDS)]
    got = H.run_hybrid_rounds(ix, rounds)
    for r, hqs_r in enumerate(rounds):
        if got[r] != H.run_hybrid_many(ix, hqs_r):
            raise AssertionError(f"hybrid rounds: round {r} differs")
    # bench.py's loop at depth 2, one pass of 4 rounds
    ts = time.perf_counter()
    pending = []
    for rep in range(HYB_ROUNDS):
        pending.append(H.run_hybrid_rounds(
            ix, [hybrid_queries(rep, "RRF")], async_=True))
        if len(pending) > 2:
            pending.pop(0).result()
    for h in pending:
        h.result()
    hyb_qps = HYB_ROUNDS * HYB_B / (time.perf_counter() - ts)
    log(f"phase hybrid: run_hybrid_rounds over {HYB_ROUNDS} rounds == "
        f"{HYB_ROUNDS} run_hybrid_many; hybrid qps {hyb_qps:.1f} (RRF, "
        f"batch {HYB_B}, bench.py's loop at depth 2, {HYB_ROUNDS} rounds, "
        f"one pass)")

    # execute_batch_rounds on bench.py's fknn numeric and tag families
    fams = fknn_families()
    for fam in ("numeric", "tag"):
        qfn = fams[fam][0]
        opts = E.QueryOptions(k=FKNN_K)

        def make(it):
            return [ix.prepare(qfn(it * FKNN_B + i),
                               {"b": fqvecs[(it * FKNN_B + i) % 512]},
                               opts, 2) for i in range(FKNN_B)]
        rounds = [make(it) for it in range(HYB_ROUNDS)]
        ts = time.perf_counter()
        got = E.execute_batch_rounds(rounds, seg, FKNN_K)
        rounds_qps = HYB_ROUNDS * FKNN_B / (time.perf_counter() - ts)
        for r, cqs_r in enumerate(rounds):
            want = E.execute_batch(cqs_r, seg, FKNN_K)
            for a, b in zip(got[r], want):
                if not (np.array_equal(a.local_idx, b.local_idx)
                        and np.array_equal(a.knn_dists, b.knn_dists)
                        and a.count == b.count):
                    raise AssertionError(f"rounds {fam}: round {r} differs")
        out[f"rounds_{fam}"] = rounds_qps
        log(f"phase hybrid: execute_batch_rounds fknn {fam} ({HYB_ROUNDS} "
            f"rounds of {FKNN_B}, KNN {FKNN_K}) == sequential execute_batch "
            f"(idx and distances bit for bit); rounds qps {rounds_qps:.1f}")
    log(f"phase hybrid: done in {time.perf_counter() - t_phase:.1f}s")
    out.update(hybrid_qps=hyb_qps, recall=recall)
    return out



# --------------------------------------------------------------- phase 8
#: bench.py's ann section (bench_ann): 1M x 100 clustered COSINE, nlist
#: 1024, 256 queries x 4 reps, k 10, nprobe 8 / 32 / 128
ANN_N, ANN_D, ANN_NLIST, ANN_K = 1_000_000, 100, 1024, 10
ANN_Q, ANN_REPS = 256, 4
ANN_NPROBES = (8, 32, 128)
#: PCIe Gen5 x16 (the H100 SXM's host link), bytes a second each way
PCIE_BYTES_PER_S = 64e9


def ann_corpus():
    """bench.py's bench_ann corpus and queries (seed 7): 256 centers,
    each vector a center plus 0.3 noise."""
    rng = np.random.default_rng(7)
    n, d, nq = ANN_N, ANN_D, ANN_Q * ANN_REPS
    centers = rng.normal(size=(256, d)).astype(np.float32)
    vecs = (centers[rng.integers(0, 256, size=n)]
            + 0.3 * rng.normal(size=(n, d))).astype(np.float32)
    queries = (centers[rng.integers(0, 256, size=nq)]
               + 0.3 * rng.normal(size=(nq, d))).astype(np.float32)
    return vecs, queries.reshape(ANN_REPS, ANN_Q, d)


def ann_truth(vecs_dev, q0):
    """Exact float64 cosine top-k of the first rep's queries, on the
    card."""
    v64 = vecs_dev.double()
    v64 = v64 / v64.norm(dim=1, keepdim=True).clamp(min=1e-30)
    q = torch.from_numpy(q0).to(vecs_dev.device).double()
    q = q / q.norm(dim=1, keepdim=True)
    truth = torch.topk(q @ v64.t(), ANN_K, dim=1).indices.cpu().numpy()
    del v64
    return [set(t.tolist()) for t in truth]


def recall_of(ids, truth) -> float:
    ids = np.asarray(ids)
    return float(np.mean([len(set(ids[i].tolist()) & truth[i]) / ANN_K
                          for i in range(len(truth))]))


def timed_qps(fn, reps) -> float:
    """Queries a second of fn(rep) over reps (host clock ending in a
    synchronize, after a warm call of rep 0)."""
    fn(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r in reps:
        fn(r)
    torch.cuda.synchronize()
    return len(reps) * ANN_Q / (time.perf_counter() - t0)


def ivf_parts(ivf, Q, nprobe, what) -> list:
    """Device ms of each part of one `ivf_probe_batch` chunk at these
    queries beside its bound: the probe product and top-nprobe, the tile
    gather, the scan product and the distance + top-k tail."""
    from redisearch_tpu_torch.ops import ivf as IVF
    nprobe = min(nprobe, ivf.nlist)
    C = IVF._chunk(Q.shape[0], nprobe, ivf.list_pad, ivf.dim)
    Qc = Q[:C]
    P, L, d = nprobe, ivf.list_pad, ivf.dim
    lists = IVF._probe_lists(ivf.centroids, ivf.cent_sq, Qc, nprobe,
                             ivf.metric)
    qf = IVF._normalize(Qc.float(), ivf.metric)
    tiles = ivf.bucket_vecs[lists]
    dots = IVF._tile_dots(tiles, qf)
    tsq, tids = ivf.bucket_sq[lists], ivf.bucket_ids[lists]
    rows = C * P * L
    parts = [
        ("probe product + top-nprobe", lambda: IVF._probe_lists(
            ivf.centroids, ivf.cent_sq, Qc, nprobe, ivf.metric),
         bound2(nbytes(ivf.centroids, ivf.cent_sq, Qc) + 8 * C * P,
                2.0 * C * ivf.nlist * d, F32_FLOPS)),
        ("tile gather", lambda: ivf.bucket_vecs[lists],
         bound2(2 * rows * d * 4 + nbytes(lists), 0, F32_FLOPS)),
        ("scan product", lambda: IVF._tile_dots(tiles, qf),
         bound2(rows * d * 4 + 4 * rows, 2.0 * rows * d, F32_FLOPS)),
        ("distance + top-k", lambda: IVF._scan_tiles_batch(
            dots, tsq, tids, qf, ANN_K, ivf.metric),
         bound2(3 * 4 * rows + 8 * C * ANN_K, 4.0 * rows, F32_FLOPS))]
    out = []
    for name, fn, (b, by) in parts:
        out.append({"part": name, "ms": time_ms(fn, iters=5), "bound_ms": b,
                    "bound_by": by, "calls": -(-Q.shape[0] // C),
                    "chunk": C})
    del tiles, dots
    for p in out:
        log(f"phase ann: {what} nprobe {nprobe} part {p['part']}: "
            f"{p['ms']:.4f} ms against {p['bound_ms']:.4f} ms "
            f"({p['bound_by']}), chunk {C}, {p['calls']} calls a batch")
    return out


def host_parts(hivf, Q, nprobe, what) -> list:
    """One host-tier batch in its parts: the probe (device), the slab
    gather into pinned memory (host clock), the copy to the card and the
    scan (device), each beside its bound (the copy's: bytes over the
    PCIe link)."""
    from redisearch_tpu_torch.ops import ivf as IVF
    from redisearch_tpu_torch.ops import lvq as LVQ
    B = Q.shape[0]
    nprobe = min(nprobe, hivf.nlist)
    lists = IVF._probe_lists(hivf.centroids, hivf.cent_sq, Q, nprobe,
                             hivf.metric).cpu().numpy()
    uniq, inv = np.unique(lists, return_inverse=True)
    hivf.gather(uniq)
    t0 = time.perf_counter()
    slabs = hivf.gather(uniq)
    gather_ms = (time.perf_counter() - t0) * 1e3
    slab_bytes = sum(t.numel() * t.element_size() for t in slabs.values())
    dev_slab = hivf.upload(slabs)
    rowmap = torch.as_tensor(inv.reshape(B, nprobe), device=Q.device)
    if hivf.compression:
        def scan():
            return LVQ.scan_slab_lvq(
                dev_slab["v"], dev_slab["off"], dev_slab["scl"],
                dev_slab["sq"], dev_slab["ids"], rowmap, Q, ANN_K,
                hivf.metric, None, None, None, False, False)
    else:
        def scan():
            return IVF._scan_slab(dev_slab["v"], dev_slab["sq"],
                                  dev_slab["ids"], rowmap, Q, ANN_K,
                                  hivf.metric, None, None, None, False,
                                  False)
    esz = dev_slab["v"].element_size()
    rows = B * nprobe * hivf.list_pad
    out = [
        {"part": "probe product + top-nprobe", "ms": time_ms(
            lambda: IVF._probe_lists(hivf.centroids, hivf.cent_sq, Q,
                                     nprobe, hivf.metric), iters=5),
         "bound": bound2(nbytes(hivf.centroids, Q) + 8 * B * nprobe,
                         2.0 * B * hivf.nlist * hivf.dim, F32_FLOPS)},
        {"part": "host slab gather (host clock)", "ms": gather_ms,
         "bound": (None, "host memory (rate not known)")},
        {"part": "copy to the card", "ms": time_ms(
            lambda: hivf.upload(slabs), iters=3),
         "bound": (slab_bytes / PCIE_BYTES_PER_S * 1e3, "bytes (PCIe)")},
        {"part": "slab scan + top-k", "ms": time_ms(scan, iters=3),
         "bound": bound2(rows * (hivf.dim * esz + 12) + 8 * B * ANN_K,
                         2.0 * rows * hivf.dim, F32_FLOPS)}]
    for p in out:
        b, by = p.pop("bound")
        p.update(bound_ms=b, bound_by=by, lists=len(uniq),
                 slab_mib=slab_bytes / 2**20)
        log(f"phase ann: {what} nprobe {nprobe} part {p['part']}: "
            f"{p['ms']:.4f} ms against "
            f"{'no bound' if b is None else f'{b:.4f} ms'} ({by}); "
            f"{len(uniq)} lists, slab {slab_bytes / 2**20:.1f} MiB")
    del dev_slab
    return out


def lvq_parity(dev):
    """tests/test_lvq.py's recall-parity case on the card: an f32 and an
    LVQ8 host tier over 4,000 x 32 normal vectors on the same centroids
    (nlist 32), 16 queries at nprobe 8: the LVQ8 ids hold at least 0.97
    of the f32 tier's, for each metric."""
    from redisearch_tpu_torch.ops import ivf as IVF
    rng = np.random.default_rng(2)
    v = rng.normal(size=(4000, 32)).astype(np.float32)
    Q = np.random.default_rng(3).normal(size=(16, 32)).astype(np.float32)
    pres = np.ones(4000, bool)
    out = {}
    for metric in ("L2", "COSINE", "IP"):
        base = IVF.HostIVF.build(v, pres, metric, nlist=32, device=dev)
        comp = IVF.HostIVF.build_lvq(
            *TL.lvq_encode(v), pres, metric,
            centroids=base.centroids.cpu().numpy(), device=dev)
        _, ib = IVF.host_ivf_knn(base, Q, 10, nprobe=8)
        _, ic = IVF.host_ivf_knn(comp, Q, 10, nprobe=8)
        out[metric] = float(np.mean([len(set(ib[i]) & set(ic[i])) / 10
                                     for i in range(16)]))
    log(f"phase ann: tests/test_lvq.py's recall parity on the card (LVQ8 "
        f"ids against the f32 tier's, nprobe 8): {out}")
    if min(out.values()) < 0.97:
        raise AssertionError(f"ann: LVQ8 recall parity {out}")


def ann_ops(dev, vecs, Qs, truth, ivf) -> dict:
    """bench.py's ann sweep at the op level: the FLAT scan, then IVF at
    each nprobe through `ivf_probe_batch` on `ivf` (the index's IVF
    field), each with its recall@10 against float64 and its QPS; the host
    tier on the IVF's own centroids must return the IVF's ids."""
    from redisearch_tpu_torch.ops import ivf as IVF
    vd = torch.from_numpy(vecs).to(dev)
    sq = (vd.double() ** 2).sum(1).float()
    present = torch.ones(ANN_N, dtype=torch.bool, device=dev)
    Qd = torch.from_numpy(Qs).to(dev)

    def flat(r):
        return V.knn_scan_batches(vd, sq, present, Qd[r:r + 1], ANN_K,
                                  "COSINE")

    _, idx0 = flat(0)
    points = [{"op": "flat", "recall": recall_of(idx0[0].cpu(), truth),
               "qps": timed_qps(flat, range(1, ANN_REPS))}]
    log(f"phase ann: the IVF field's IVFIndex: nlist {ivf.nlist}, list_pad "
        f"{ivf.list_pad}, device {ivf.memory_bytes() / 2**30:.2f} GiB")
    parts = {}
    for nprobe in ANN_NPROBES:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        _, ids = IVF.ivf_probe_batch(ivf, Qd[0], ANN_K, nprobe)
        torch.cuda.synchronize(dev)
        peak = torch.cuda.max_memory_allocated(dev) - base
        qps = timed_qps(lambda r: IVF.ivf_probe_batch(ivf, Qd[r], ANN_K,
                                                      nprobe),
                        range(1, ANN_REPS))
        points.append({"op": f"ivf{nprobe}",
                       "recall": recall_of(ids.cpu(), truth), "qps": qps,
                       "peak_gib": peak / 2**30})
        parts[nprobe] = ivf_parts(ivf, Qd[0], nprobe, "ivf_probe_batch")
    # the host tier on the IVF's centroids: the same lists, so the same
    # ids (test_host_tier_pure_knn_matches_hbm_ivf's claim)
    hivf = IVF.HostIVF.build(vecs, np.ones(ANN_N, bool), "COSINE",
                             centroids=ivf.centroids.cpu().numpy(),
                             device=dev)
    for nprobe in ANN_NPROBES:
        hd, hi = IVF.host_ivf_knn(hivf, Qs[0], ANN_K, nprobe)
        dd, di = IVF.ivf_probe_batch(ivf, Qd[0], ANN_K, nprobe)
        dd, di = dd.cpu().numpy(), di.cpu().numpy()
        if not np.abs(hd - dd).max() <= 1e-5:
            raise AssertionError(f"ann: host tier vs IVF distances at "
                                 f"nprobe {nprobe}")
        near = np.zeros(hd.shape, bool)
        near[:, 1:] |= np.diff(dd, axis=1) <= 1e-5
        near[:, :-1] |= np.diff(dd, axis=1) <= 1e-5
        if ((hi != di) & ~near).any():
            raise AssertionError(f"ann: host tier vs IVF ids at nprobe "
                                 f"{nprobe}")
    log("phase ann: host tier on the IVF's centroids == ivf_probe_batch "
        "(ids lane for lane but for ties within 1e-5, distances within "
        "1e-5) at nprobe " + "/".join(map(str, ANN_NPROBES)))
    for p in points:
        log(f"phase ann: op {p['op']}: recall@10 {p['recall']:.4f}, qps "
            f"{p['qps']:.1f}" + (f", peak transient {p['peak_gib']:.2f} GiB"
                                 if "peak_gib" in p else ""))
    if points[0]["recall"] < 0.999:
        raise AssertionError(f"ann: FLAT recall {points[0]['recall']}")
    if points[-1]["recall"] < 0.95:
        raise AssertionError(f"ann: IVF recall at nprobe 128 "
                             f"{points[-1]['recall']}")
    del vd, sq, hivf
    torch.cuda.empty_cache()
    return {"points": points, "parts": parts}


def phase_ann(dev) -> dict:
    """Phase 8 (see the docstring)."""
    from torch.profiler import ProfilerActivity, profile
    t0 = time.perf_counter()
    vecs, Qs = ann_corpus()
    truth = ann_truth(torch.from_numpy(vecs).to(dev), Qs[0])
    log(f"phase ann: corpus {ANN_N:,} x {ANN_D} and float64 truth in "
        f"{time.perf_counter() - t0:.1f}s")
    client = rt.Client(device=dev)
    vp = dict(dim=ANN_D, metric="COSINE", nlist=ANN_NLIST)
    t1 = time.perf_counter()
    ix = client.ft_create("ann", [
        rt.Field("iv", rt.FieldType.VECTOR, vector=rt.VectorParams(
            algo="IVF", **vp)),
        rt.Field("hv", rt.FieldType.VECTOR, vector=rt.VectorParams(
            algo="IVF", storage="host", **vp)),
        rt.Field("lv", rt.FieldType.VECTOR, vector=rt.VectorParams(
            algo="IVF", storage="host", compression="LVQ8", **vp))])
    before = torch.cuda.memory_allocated(dev)
    ix.add_documents((f"v{i}", {"iv": vecs[i], "hv": vecs[i],
                                "lv": vecs[i]}) for i in range(ANN_N))
    torch.cuda.synchronize(dev)
    seg = ix.segments[0]
    cols = seg.vectors
    log(f"phase ann: ft_create + add_documents (three fields, three IVF "
        f"builds) {time.perf_counter() - t1:.1f}s; device "
        f"{(torch.cuda.memory_allocated(dev) - before) / 2**30:.2f} GiB "
        f"(IVF field {cols['iv'].ivf.memory_bytes() / 2**30:.2f} GiB), "
        f"host {seg.host_bytes() / 2**30:.2f} GiB (host tier f32 "
        f"{cols['hv'].host_ivf.host_bytes() / 2**30:.2f} GiB, LVQ8 "
        f"{cols['lv'].host_ivf.host_bytes() / 2**30:.2f} GiB)")
    ops = ann_ops(dev, vecs, Qs, truth, cols["iv"].ivf)
    route = {"iv": "window", "hv": "knn-host", "lv": "knn-host"}
    # LVQ8 scans are exact against the reconstructions: their own truth
    lv = cols["lv"]
    recon = TL.lvq_decode(lv.vecs[:ANN_N], lv.vq_off[:ANN_N],
                          lv.vq_scl[:ANN_N])
    truth_lv = ann_truth(torch.from_numpy(recon).to(dev), Qs[0])
    del recon
    entry, recalls = [], {}
    for f in ("iv", "hv", "lv"):
        for nprobe in ANN_NPROBES:
            q = f"*=>[KNN {ANN_K} @{f} $b EF_RUNTIME {nprobe}]"
            params = [[{"b": Qs[r, i]} for i in range(ANN_Q)]
                      for r in range(ANN_REPS)]
            E.QUERY_PATH_STATS.clear()
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev)
            res = client.ft_search_many("ann", [q] * ANN_Q,
                                        params=params[0], k=ANN_K)
            torch.cuda.synchronize(dev)
            peak = torch.cuda.max_memory_allocated(dev) - base
            if E.QUERY_PATH_STATS != {route[f]: ANN_Q}:
                raise AssertionError(f"ann {f}: routes "
                                     f"{E.QUERY_PATH_STATS}")
            ids = [[int(h.key[1:]) for h in r.hits] for r in res]
            rec = recall_of(ids, truth)
            recalls[(f, nprobe)] = rec
            if f == "lv":
                recalls[("lv-recon", nprobe)] = recall_of(ids, truth_lv)
            for i in range(0, ANN_Q, 32):
                one = client.ft_search("ann", q, params=params[0][i],
                                       num=ANN_K)
                if [h.key for h in one.hits] != [h.key for h in
                                                 res[i].hits]:
                    raise AssertionError(f"ann {f} nprobe {nprobe}: single "
                                         f"query {i} differs from batch")
            qps = timed_qps(lambda r: client.ft_search_many(
                "ann", [q] * ANN_Q, params=params[r], k=ANN_K),
                range(1, ANN_REPS))
            entry.append({"field": f, "route": route[f], "nprobe": nprobe,
                          "recall": rec, "qps": qps,
                          "peak_gib": peak / 2**30})
            log(f"phase ann: ft_search_many @{f} ({route[f]}) nprobe "
                f"{nprobe}: recall@10 {rec:.4f}"
                + (f" (against the reconstructions' own float64 top-10: "
                   f"{recalls[('lv-recon', nprobe)]:.4f})" if f == "lv"
                   else "")
                + f", 8 single ft_search equal to the batch, qps {qps:.1f}, "
                f"peak transient {peak / 2**30:.2f} GiB")
    for key in (("iv", 128), ("hv", 128), ("lv-recon", 128)):
        if recalls[key] < 0.95:
            raise AssertionError(f"ann: recall {key}: {recalls[key]}")
    lvq_parity(dev)
    traces = {}
    for f in ("iv", "hv", "lv"):
        q = f"*=>[KNN {ANN_K} @{f} $b EF_RUNTIME 32]"
        # the window route runs a program per query: trace an eighth
        nt = ANN_Q // 8 if f == "iv" else ANN_Q
        params = [{"b": Qs[0, i]} for i in range(nt)]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            ts = time.perf_counter()
            client.ft_search_many("ann", [q] * nt, params=params,
                                  k=ANN_K)
            torch.cuda.synchronize(dev)
            traced = (time.perf_counter() - ts) * 1e3
        busy, _ = device_busy_us(prof, ())
        traces[f] = {"ms": traced, "busy_us": busy,
                     "idle": 1.0 - busy / (traced * 1e3)}
        log(f"phase ann: traced batch @{f} nprobe 32 ({nt} queries): "
            f"{traced:.3f} ms, device busy {busy:.1f} us, idle share "
            f"{traces[f]['idle']:.4f}")
    Qd = torch.from_numpy(Qs[0]).to(dev)
    hparts = {f: host_parts(cols[f].host_ivf, Qd, nprobe,
                            f"host tier @{f}")
              for f in ("hv", "lv") for nprobe in (32,)}
    log("phase ann: json " + json.dumps({
        "ops": ops["points"], "entry": entry, "traces": traces,
        "parts": {str(k): v for k, v in ops["parts"].items()},
        "host_parts": hparts}))
    del ix, client, seg, cols
    torch.cuda.empty_cache()
    return {"ops": ops, "entry": entry}


# --------------------------------------------------------------- phase 9
GEO_N, GEO_B = 1_000_000, 1024
GEO_LON0, GEO_LAT0 = 2.35, 48.85
#: half the 50 km box, in degrees of latitude and of longitude there
GEO_DLAT = 25.0 / 111.195
GEO_DLON = GEO_DLAT / np.cos(np.radians(GEO_LAT0))
GEO_WORDS = [f"g{i:02d}" for i in range(40)]
EARTH_M = 6372797.560856


def geo_corpus():
    """1M docs, one GEO point each, uniform over a 50 km box (6
    decimals, as a client sends them), two of 40 words, a TAG of 16
    values; seed 11."""
    rng = np.random.default_rng(11)
    lon = np.round(GEO_LON0 + rng.uniform(-GEO_DLON, GEO_DLON, GEO_N), 6)
    lat = np.round(GEO_LAT0 + rng.uniform(-GEO_DLAT, GEO_DLAT, GEO_N), 6)
    pts = [f"{a:.6f},{b:.6f}" for a, b in zip(lon, lat)]
    w = rng.integers(0, len(GEO_WORDS), size=(GEO_N, 2))
    words = np.array(GEO_WORDS)
    docs = [(f"g{i}", {"t": f"{words[w[i, 0]]} {words[w[i, 1]]}",
                       "c": f"c{i % 16}", "loc": pts[i]})
            for i in range(GEO_N)]
    return docs, w


def geo_families():
    """(query of i, host filter of i) per family: radius 1-20 km around a
    point of the box, alone, AND a term, AND a TAG."""
    rng = np.random.default_rng(12)
    qlon = GEO_LON0 + rng.uniform(-GEO_DLON, GEO_DLON, GEO_B) * 0.8
    qlat = GEO_LAT0 + rng.uniform(-GEO_DLAT, GEO_DLAT, GEO_B) * 0.8
    rad = 1 + np.arange(GEO_B) % 20

    def geo(i):
        return f"@loc:[{qlon[i]:.5f} {qlat[i]:.5f} {rad[i]} km]"
    word_masks, tag_masks = {}, {}

    def word_mask(i, w):
        if i % 40 not in word_masks:
            word_masks[i % 40] = (w == i % 40).any(1)
        return word_masks[i % 40]

    def tag_mask(i, w):
        if i % 16 not in tag_masks:
            tag_masks[i % 16] = np.arange(GEO_N) % 16 == i % 16
        return tag_masks[i % 16]
    fams = {
        "geo": (geo, lambda i, w: None),
        "geo_term": (lambda i: f"{GEO_WORDS[i % 40]} {geo(i)}", word_mask),
        "geo_tag": (lambda i: f"@c:{{c{i % 16}}} {geo(i)}", tag_mask)}
    # each query's point as the parser stores it: f32 radians
    qpts = [(float(np.float32(np.radians(float(f"{qlon[i]:.5f}")))),
             float(np.float32(np.radians(float(f"{qlat[i]:.5f}")))),
             rad[i] * 1000.0) for i in range(GEO_B)]
    return fams, qpts


def check_geo(res, qpts, fmask_fn, lon_d, lat_d, w, what) -> int:
    """Every query against a float64 haversine on the card, over the f32
    radians the index holds: totals equal but for docs within 1e-6
    relative of the radius (the f32 edge), and each hit inside the radius
    (same edge rule) and passing the filter; where every match scores
    the same (no term), the hits are the lowest doc ids that match.
    Distances go 32 queries at a time.  Returns the count of edge docs
    met."""
    n_edge = 0
    dev = lon_d.device
    for c0 in range(0, len(res), 32):
        rows = range(c0, min(len(res), c0 + 32))
        ql = torch.tensor([qpts[i][0] for i in rows], dtype=torch.float64,
                          device=dev)[:, None]
        qa = torch.tensor([qpts[i][1] for i in rows], dtype=torch.float64,
                          device=dev)[:, None]
        rad = torch.tensor([qpts[i][2] for i in rows], dtype=torch.float64,
                           device=dev)[:, None]
        a = (torch.sin((lat_d[None] - qa) / 2) ** 2
             + torch.cos(lat_d)[None] * torch.cos(qa)
             * torch.sin((lon_d[None] - ql) / 2) ** 2)
        d = 2 * EARTH_M * torch.arcsin(torch.sqrt(a.clamp(0, 1)))
        inside = d <= rad
        edge = (d - rad).abs() <= 1e-6 * rad
        del a, d
        masks = [fmask_fn(i, w) for i in rows]
        if masks[0] is not None:
            mt = torch.from_numpy(np.stack(masks)).to(dev)
            inside, edge = inside & mt, edge & mt
        n_in = inside.sum(1).tolist()
        n_e = edge.sum(1).tolist()
        n_edge += sum(n_e)
        for j, i in enumerate(rows):
            r = res[i]
            if abs(r.total - n_in[j]) > n_e[j]:
                raise AssertionError(f"{what} {i}: total {r.total}, "
                                     f"float64 {n_in[j]} ({n_e[j]} at the "
                                     "edge)")
            keys = torch.tensor([int(h.key[1:]) for h in r.hits],
                                dtype=torch.long, device=dev)
            ok = inside[j] | edge[j]
            if len(keys) and not bool(ok[keys].all()):
                raise AssertionError(f"{what} {i}: a hit outside the "
                                     "radius or its filter")
            if "term" not in what and n_e[j] == 0:
                want = torch.nonzero(inside[j]).flatten()[:len(keys)]
                if not bool((want == keys).all()):
                    raise AssertionError(f"{what} {i}: hits are not the "
                                         "lowest matching docs")
    return n_edge


def phase_geo(dev) -> dict:
    """Phase 9 (see the docstring)."""
    from torch.profiler import ProfilerActivity, profile
    t0 = time.perf_counter()
    docs, w = geo_corpus()
    t1 = time.perf_counter()
    client = rt.Client(device=dev)
    ix = client.ft_create("geo", [rt.Field("t", rt.FieldType.TEXT),
                                  rt.Field("c", rt.FieldType.TAG),
                                  rt.Field("loc", rt.FieldType.GEO)])
    ix.add_documents(docs)
    torch.cuda.synchronize(dev)
    del docs
    seg = ix.segments[0]
    log(f"phase geo: corpus {GEO_N:,} docs in {t1 - t0:.1f}s, ingest "
        f"{time.perf_counter() - t1:.1f}s, segment "
        f"{seg.memory_bytes() / 2**30:.3f} GiB (GEO columns "
        f"{nbytes(seg.geos['loc'].lon, seg.geos['loc'].lat, seg.geos['loc'].present) / 2**20:.1f} MiB)")
    lon_d = seg.geos["loc"].lon[:GEO_N].double()
    lat_d = seg.geos["loc"].lat[:GEO_N].double()
    fams, qpts = geo_families()
    out = {}
    for fam, (qfn, ffn) in fams.items():
        qs = [qfn(i) for i in range(GEO_B)]
        E.QUERY_PATH_STATS.clear()
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        ts = time.perf_counter()
        res = client.ft_search_many("geo", qs, k=K)
        torch.cuda.synchronize(dev)
        qps = GEO_B / (time.perf_counter() - ts)
        peak = torch.cuda.max_memory_allocated(dev) - base
        if E.QUERY_PATH_STATS != {"window": GEO_B}:
            raise AssertionError(f"geo {fam}: routes {E.QUERY_PATH_STATS}")
        n_edge = check_geo(res, qpts, ffn, lon_d, lat_d, w, f"geo {fam}")
        for i in range(0, GEO_B, GEO_B // 16):
            one = client.ft_search("geo", qs[i], num=K)
            same_hits(one, res[i], f"geo {fam} single {i}")
        nt = GEO_B // 16
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            ts = time.perf_counter()
            client.ft_search_many("geo", qs[:nt], k=K)
            torch.cuda.synchronize(dev)
            traced = (time.perf_counter() - ts) * 1e3
        busy, _ = device_busy_us(prof, ())
        out[fam] = {"qps": qps, "edge_docs": n_edge, "peak": peak,
                    "idle": 1.0 - busy / (traced * 1e3)}
        log(f"phase geo: {fam} (window, batch {GEO_B}): every query == "
            f"float64 haversine on the card ({n_edge} edge docs), 16 single "
            f"ft_search equal; qps {qps:.1f}, peak transient "
            f"{peak / 2**30:.2f} GiB; traced {nt} queries {traced:.3f} ms, "
            f"device busy {busy:.1f} us, idle share "
            f"{out[fam]['idle']:.4f}")
    g = seg.geos["loc"]
    qlon = torch.tensor(qpts[0][0], dtype=torch.float32, device=dev)
    qlat = torch.tensor(qpts[0][1], dtype=torch.float32, device=dev)
    rad = torch.tensor(qpts[0][2], dtype=torch.float32, device=dev)
    ms = time_ms(lambda: T.geo_radius_mask(g.lon, g.lat, g.present, qlon,
                                           qlat, rad), iters=20)
    b, by = bound2(nbytes(g.lon, g.lat, g.present) + g.present.numel(),
                   20.0 * GEO_N, F32_FLOPS)
    log(f"phase geo: geo_radius_mask over {GEO_N:,} docs: {ms:.4f} ms "
        f"against {b:.4f} ms ({by})")
    log("phase geo: json " + json.dumps(
        {"families": out, "mask": {"ms": ms, "bound_ms": b,
                                   "bound_by": by}}))
    del ix, client, seg, lon_d, lat_d
    torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------- phase 10
COLD_B = 256


def device_tensors(obj, seen=None) -> dict:
    """Every torch tensor reachable from a segment's fields, by id."""
    import dataclasses as dc
    seen = {} if seen is None else seen
    if isinstance(obj, torch.Tensor):
        seen[id(obj)] = obj
    elif dc.is_dataclass(obj):
        for f in dc.fields(obj):
            device_tensors(getattr(obj, f.name), seen)
    elif isinstance(obj, dict):
        for v in obj.values():
            device_tensors(v, seen)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            device_tensors(v, seen)
    return seen


def phase_cold(dev, main) -> dict:
    """Phase 10 (see the docstring): the main path's corpus (`main`,
    phase 4's result) as a cold index, against phase 4's hot index."""
    from torch.profiler import ProfilerActivity, profile
    import gc
    docs, qt, hot_client = main["docs"], main["qt"], main["client"]
    client = rt.Client(device=dev)
    # earlier phases' indexes may sit in reference cycles: free them now
    # so that the count below sees only what this index adds
    gc.collect()
    torch.cuda.synchronize(dev)
    before = torch.cuda.memory_allocated(dev)
    t1 = time.perf_counter()
    ix = client.ft_create("cold", bm25_fields(), storage="host")
    ix.add_documents(docs)
    gc.collect()
    torch.cuda.synchronize(dev)
    added = torch.cuda.memory_allocated(dev) - before
    del docs
    seg = ix.segments[0]
    hot = hot_client._indexes["bm25"].segments[0]
    dense = seg.memory_bytes()
    log(f"phase cold: the main path's corpus, ingest "
        f"{time.perf_counter() - t1:.1f}s; device memory added "
        f"{added / 2**20:.1f} MiB, its dense columns "
        f"{dense / 2**20:.1f} MiB in {len(device_tensors(seg))} tensors, "
        f"host CSR {seg.host_bytes() / 2**20:.1f} MiB; the hot segment "
        f"{hot.memory_bytes() / 2**20:.1f} MiB")
    # the caching allocator may keep a large block's remainder (under
    # 1 MiB) whole, so each device tensor may count up to 1 MiB more
    n_dev = len(device_tensors(seg))
    if not seg.cold or added > dense + n_dev * 2**20:
        raise AssertionError(f"cold: {added} device bytes added against "
                             f"{dense} of dense columns ({n_dev} tensors)")
    out = {}
    for fam, fn in FAMILIES.items():
        qs = [fn(qt, i) for i in range(COLD_B)]
        hres = hot_client.ft_search_many("bm25", qs, k=K)
        E.QUERY_PATH_STATS.clear()
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        ts = time.perf_counter()
        res = client.ft_search_many("cold", qs, k=K)
        torch.cuda.synchronize(dev)
        dt = time.perf_counter() - ts
        peak = torch.cuda.max_memory_allocated(dev) - base
        if E.QUERY_PATH_STATS != {"cold": COLD_B}:
            raise AssertionError(f"cold {fam}: routes {E.QUERY_PATH_STATS}")
        for i, (c, h) in enumerate(zip(res, hres)):
            same_hits(c, h, f"cold {fam} {i} vs hot")
        # the host's part of a query: binding and paging its slabs
        cqs = [ix.prepare(q, None, E.QueryOptions(k=K), 2) for q in qs]
        ts = time.perf_counter()
        for cq in cqs:
            binding, _P = cq.bind(seg)
            dyn = dict(binding.dyn)
            dyn.pop("_tagL", None)
            buckets = dyn.pop("_buckets")
            E._cold_slab_args(cq, seg, dyn, buckets)
        torch.cuda.synchronize(dev)
        slab_ms = (time.perf_counter() - ts) * 1e3 / COLD_B
        nt = COLD_B // 8
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            ts = time.perf_counter()
            client.ft_search_many("cold", qs[:nt], k=K)
            torch.cuda.synchronize(dev)
            traced = (time.perf_counter() - ts) * 1e3
        busy, _ = device_busy_us(prof, ())
        out[fam] = {"qps": COLD_B / dt, "ms_per_query": dt * 1e3 / COLD_B,
                    "slab_ms": slab_ms, "peak": peak,
                    "idle": 1.0 - busy / (traced * 1e3)}
        log(f"phase cold: {fam} (cold, {COLD_B} queries): every query == "
            f"the hot index's; qps {COLD_B / dt:.1f} "
            f"({dt * 1e3 / COLD_B:.3f} ms a query, of it bind + slab "
            f"paging {slab_ms:.3f} ms), peak transient "
            f"{peak / 2**20:.1f} MiB; traced {nt} queries {traced:.3f} ms, "
            f"device busy {busy:.1f} us, idle share "
            f"{out[fam]['idle']:.4f}")
    log("phase cold: json " + json.dumps(
        {"families": out, "device_added": added, "dense": dense,
         "host_csr": seg.host_bytes(), "hot": hot.memory_bytes()}))
    del ix, client, seg
    torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------- phase 11
LIFE_B = 256              # queries a family on the dirty and 2-seg index
CKPT_DIR = "_ckpt"        # git-ignored, in the checkout; removed after


def served_families(client, name, batches, dev) -> tuple:
    """`ft_search_many` of every family on index `name` with the path and
    launch counters zeroed just before and read just after: (results,
    path stats, (B1 launches, B1 wide launches, B2 launches), seconds a
    family)."""
    E.QUERY_PATH_STATS.clear()
    IK.LAUNCHES = IK.WIDE_LAUNCHES = IK.PHRASE_LAUNCHES = 0
    res, secs = {}, {}
    for fam, qs in batches.items():
        t0 = time.perf_counter()
        res[fam] = client.ft_search_many(name, qs, k=K)
        torch.cuda.synchronize(dev)
        secs[fam] = time.perf_counter() - t0
    stats = {r: n for r, n in E.QUERY_PATH_STATS.items() if n}
    return res, stats, (IK.LAUNCHES - IK.WIDE_LAUNCHES, IK.WIDE_LAUNCHES,
                        IK.PHRASE_LAUNCHES), secs


def hit_pct(stats) -> float:
    """bench.py's kernel_hit_pct of a run's path stats."""
    n = sum(stats.values())
    return 100.0 * (n - stats.get("window", 0)) / n


def phase_life_checkpoint(client, ix, batches, dev) -> dict:
    """Phase 11(a): `save_index` the clean 1M-doc index (stored npz
    members), `load_index` it as a second index, serve the eight
    families on it (same routes, B1 and B2 launched, results equal to the
    original's with bit-identical scores), then `ft_dropindex` it.  The
    save's parts are timed apart, and the arrays are written once more
    with compressed members, as the JAX package writes them (its
    host.pkl is the same)."""
    import gc
    import shutil
    from redisearch_tpu_torch.aux import checkpoint as CK
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        CKPT_DIR)
    shutil.rmtree(root, ignore_errors=True)
    orig, ostats, _l, _s = served_families(client, "bm25", batches, dev)
    path = os.path.join(root, "stored")
    t0 = time.perf_counter()
    client.save_index("bm25", path)
    save_s = time.perf_counter() - t0
    size = {f: os.path.getsize(os.path.join(path, f))
            for f in os.listdir(path)}
    arrays: dict = {}
    t0 = time.perf_counter()
    CK._collect_arrays(ix.segments[0], "seg0", arrays, {})
    collect_s = time.perf_counter() - t0
    npz = {}
    for compress in (False, True):
        t0 = time.perf_counter()
        (np.savez_compressed if compress else np.savez)(
            os.path.join(root, f"arrays{int(compress)}.npz"), **arrays)
        npz[compress] = time.perf_counter() - t0
    z_bytes = os.path.getsize(os.path.join(root, "arrays1.npz"))
    del arrays
    gc.collect()
    torch.cuda.synchronize(dev)
    before = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    lix = client.load_index("bm25_ck", path)
    torch.cuda.synchronize(dev)
    load_s = time.perf_counter() - t0
    loaded = torch.cuda.memory_allocated(dev) - before
    res, stats, launches, _s = served_families(client, "bm25_ck", batches,
                                               dev)
    log(f"phase lifecycle: (a) save_index {save_s:.2f}s ({size}); of a "
        f"save, the arrays' copy to the host {collect_s:.2f}s and "
        f"arrays.npz {npz[False]:.2f}s stored, {npz[True]:.2f}s compressed"
        f" ({z_bytes} bytes); load_index {load_s:.2f}s; the loaded index "
        f"holds {loaded / 2**20:.1f} MiB on the card; path stats {stats} "
        f"(the original's {ostats}), kernel_hit_pct {hit_pct(stats):.2f}; "
        f"B1 launches {launches[0]} (wide {launches[1]}), B2 {launches[2]}")
    if stats != ostats or launches[0] <= 0 or launches[2] <= 0:
        raise AssertionError(f"loaded index: routes {stats} vs {ostats}, "
                             f"launches {launches}")
    for fam in batches:
        for i, (a, b) in enumerate(zip(res[fam], orig[fam])):
            if (a.total != b.total or [h.key for h in a.hits]
                    != [h.key for h in b.hits]
                    or [h.score for h in a.hits]
                    != [h.score for h in b.hits]):
                raise AssertionError(f"loaded {fam} {i}: {a.total} "
                                     f"{a.hits} vs {b.total} {b.hits}")
    log(f"phase lifecycle: (a) the loaded checkpoint's {len(batches)} "
        f"families == the original's (keys, totals, scores bit for bit)")
    del res, lix
    gc.collect()
    torch.cuda.synchronize(dev)
    mem_loaded = torch.cuda.memory_allocated(dev)
    client.ft_dropindex("bm25_ck")
    gc.collect()
    torch.cuda.synchronize(dev)
    mem_dropped = torch.cuda.memory_allocated(dev)
    shutil.rmtree(root)
    log(f"phase lifecycle: (a) ft_dropindex: device memory allocated "
        f"{mem_loaded / 2**20:.1f} -> {mem_dropped / 2**20:.1f} MiB")
    if client.ft_list() != ["bm25"]:
        raise AssertionError(f"ft_dropindex: {client.ft_list()}")
    return dict(save_s=save_s, bytes=size, collect_s=collect_s,
                npz_s=npz[False], npz_z_s=npz[True], npz_z_bytes=z_bytes,
                load_s=load_s, loaded=loaded,
                mem=(mem_loaded, mem_dropped))


def live_and2_docs(seg, ix, q) -> np.ndarray:
    """numpy_and2_docs restricted to the docs alive in `seg`."""
    d = numpy_and2_docs(seg, ix, q)
    return d[seg.alive_np[d]]


def phase_life_dirty(client, ix, small, dev) -> dict:
    """Phase 11(b): `Client.hdel` 200,000 keys (i % 5 == 1); the segment
    stays (20% < 25%) and serves on the window program, no hit a deleted
    key, and2 totals and aggregate sums equal numpy over the live
    docs."""
    seg = ix.segments[0]
    dead = [f"d{i}" for i in range(1, N_DOCS, 5)]
    t0 = time.perf_counter()
    for key in dead:
        client.hdel(key)
    torch.cuda.synchronize(dev)
    del_s = time.perf_counter() - t0
    ix.maybe_compact()
    if ix.segments[0] is not seg or seg.n_deleted != len(dead):
        raise AssertionError("maybe_compact did not keep the segment at "
                             f"20%: {len(ix.segments)} segments, "
                             f"n_deleted {ix.segments[0].n_deleted}")
    log(f"phase lifecycle: (b) hdel {len(dead)} keys in {del_s:.2f}s "
        f"({len(dead) / del_s:.0f} deletes/s); maybe_compact kept the "
        f"segment at 20% deleted")
    res, stats, _l, secs = served_families(client, "bm25", small, dev)
    if stats != {"window": LIFE_B * len(small)}:
        raise AssertionError(f"dirty segment: routes {stats}")
    for fam, rs_ in res.items():
        for r in rs_:
            if any(int(h.key[1:]) % 5 == 1 for h in r.hits):
                raise AssertionError(f"dirty {fam}: a deleted key served")
    for q, r in list(zip(small["and2"], res["and2"]))[:16]:
        want = len(live_and2_docs(seg, ix, q))
        if r.total != want:
            raise AssertionError(f"dirty and2 {q!r}: {r.total} != {want}")
    mk = agg_request_fn()[0]
    reqs = [mk(i) for i in range(64)]
    AP.AGG_PATH_STATS.clear()
    agg = client.ft_aggregate_many("bm25", reqs)
    astats = dict(AP.AGG_PATH_STATS)
    grp_ids = seg.strcols["grp"].value_ids.cpu().numpy()
    price = seg.numerics["price"].values.cpu().numpy()
    table = seg.strcols["grp"].table
    for req, r in zip(reqs, agg):
        total, top = numpy_agg_top(seg, ix, None, grp_ids, table, price,
                                   docs=live_and2_docs(seg, ix, req.query))
        got = [(x["grp"], x["n"]) for x in r.rows]
        if r.total != total or got != [t_[:2] for t_ in top] or any(
                abs(x["s"] - t_[2]) > 1e-5 * t_[2]
                for x, t_ in zip(r.rows, top)):
            raise AssertionError(f"dirty aggregate {req.query!r}: {r.total}"
                                 f" {r.rows} != numpy {total} {top}")
    qps = {fam: LIFE_B / s for fam, s in secs.items()}
    log(f"phase lifecycle: (b) {LIFE_B} queries a family on the dirty "
        f"segment all on the window program, no deleted key served; 16 "
        f"and2 totals == numpy over the live docs; 64 aggregate requests "
        f"({astats}) == numpy group-by over the live docs (COUNT exact, "
        f"SUM within 1e-5); qps "
        + ", ".join(f"{f} {v:.1f}" for f, v in qps.items()))
    return dict(del_s=del_s, n_del=len(dead), qps=qps)


def phase_life_compact(client, ix, dev) -> dict:
    """Phase 11(c): `ft_del` 60,000 more keys (26% deleted), then
    `maybe_compact` compacts through the slice path into one clean
    segment of 740,000 docs."""
    more = [f"d{i}" for i in range(3, N_DOCS, 5)][:N_DOCS * 6 // 100]
    t0 = time.perf_counter()
    for key in more:
        client.ft_del("bm25", key)
    torch.cuda.synchronize(dev)
    del_s = time.perf_counter() - t0
    old = ix.segments[0]
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    ix.maybe_compact()
    torch.cuda.synchronize(dev)
    comp_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) - base
    seg = ix.segments[0]
    tm = ix.stats.get("last_compaction", {})
    log(f"phase lifecycle: (c) ft_del {len(more)} more keys in "
        f"{del_s:.2f}s ({len(more) / del_s:.0f} deletes/s, 26% deleted); "
        f"maybe_compact {comp_s:.2f}s: live_locals "
        f"{tm.get('live_locals_s', 0):.2f}s, slice "
        f"{tm.get('slice_s', 0):.2f}s, upload {tm.get('upload_s', 0):.2f}s,"
        f" ANN {tm.get('build_ann_s', 0):.2f}s; peak transient device "
        f"memory {peak / 2**20:.1f} MiB over the "
        f"{base / 2**20:.1f} MiB before; segment nnz {old.text.nnz} -> "
        f"{seg.text.nnz}, {old.memory_bytes() / 2**20:.1f} -> "
        f"{seg.memory_bytes() / 2**20:.1f} MiB")
    n_live = N_DOCS - old.n_deleted
    if (len(ix.segments) != 1 or seg is old or seg.n_docs != n_live
            or seg.n_deleted != 0 or tm.get("path") != "slice"):
        raise AssertionError(f"compaction: {len(ix.segments)} segments, "
                             f"n_docs {seg.n_docs}, n_deleted "
                             f"{seg.n_deleted}, {tm}")
    return dict(del_s=del_s, n_del=len(more), compact_s=comp_s, peak=peak,
                **{k: v for k, v in tm.items() if k != "path"})


def phase_life_served(client, ix, batches, dev) -> dict:
    """Phase 11(d): the compacted index back on the kernels: the eight
    families at batch 8192 (no window query, each against its plain
    recomputation), 256 phrases cut from live docs on B2, bench.py's
    aggregate at batch 1024 on the device tail against plain, and '*'
    GROUPBY @grp COUNT over the 740,000 docs.  The kernels' launch
    counters are zeroed just before this run and read just after."""
    seg = ix.segments[0]
    seg.tag_pcodes("cat")     # set-up: the dense code column, built once
    client.ft_search_many("bm25", batches["and2"][:64], k=K)
    GB.LAUNCHES = GB.SINGLE_LAUNCHES = 0
    res, stats, launches, secs = served_families(client, "bm25", batches,
                                                 dev)
    log(f"phase lifecycle: (d) path stats {stats}, kernel_hit_pct "
        f"{hit_pct(stats):.2f}; B1 launches {launches[0]} (wide "
        f"{launches[1]}), B2 {launches[2]}")
    if "window" in stats or launches[0] <= 0 or launches[2] <= 0:
        raise AssertionError(f"compacted index off the kernels: {stats} "
                             f"{launches}")
    err = {"intersect": 0.0, "phrase": 0.0}
    for fam, qs in batches.items():
        kres = E.execute_batch(
            [ix.prepare(q, None, E.QueryOptions(k=K), 2) for q in qs],
            seg, K)
        pres, _largest = plain_results(ix, seg, qs)
        name = "phrase" if fam == "phrase" else "intersect"
        err[name] = max(err[name], check_against_plain(kres, pres, fam))
    log(f"phase lifecycle: (d) all {len(batches)} x {BATCH} queries "
        f"kernel == plain")
    # phrases cut from live docs' bodies
    rng = np.random.default_rng(29)
    qs, src = [], []
    while len(qs) < LIFE_B:
        local = int(rng.integers(0, seg.n_docs))
        body = ix.doctable.get(int(seg.gids_np[local])).fields["body"]
        words = body.split()
        T = int(rng.integers(2, 5))
        j = int(rng.integers(0, len(words) - T + 1))
        q = '"' + " ".join(words[j:j + T]) + '"'
        if kernel_eligible(ix, seg, q):
            qs.append(q)
            src.append(local)
    E.QUERY_PATH_STATS.clear()
    IK.PHRASE_LAUNCHES = 0
    kres = E.execute_batch([ix.prepare(q, None, E.QueryOptions(k=K), 2)
                            for q in qs], seg, K)
    p_runs = IK.PHRASE_LAUNCHES
    if dict(E.QUERY_PATH_STATS) != {"phrase-kernel": LIFE_B} or \
            p_runs <= 0:
        raise AssertionError(f"live phrases: {E.QUERY_PATH_STATS}")
    for q, local, kr in zip(qs, src, kres):
        live = kr.local_idx[kr.scores > -3.3e38]
        if kr.count < 1 or (kr.count <= K and local not in live):
            raise AssertionError(f"live phrase {q!r} misses its doc")
    pres, _largest = plain_results(ix, seg, qs)
    err["phrase"] = max(err["phrase"],
                        check_against_plain(kres, pres, "live phrases"))
    log(f"phase lifecycle: (d) {LIFE_B} phrases cut from live docs rode "
        f"B2 ({p_runs} launches), each matches its doc, == plain")
    # bench.py's aggregate at batch 1024 on the device tail
    mk = agg_request_fn()[0]
    reqs, drawn = [], 0
    while len(reqs) < AGG_BATCH:
        r = mk(drawn)
        drawn += 1
        if agg_eligible(ix, seg, r):
            reqs.append(r)
    AP.AGG_PATH_STATS.clear()
    gb0, raw0 = GB.LAUNCHES, IK.LAUNCHES
    agg = client.ft_aggregate_many("bm25", reqs)
    torch.cuda.synchronize(dev)
    gb_l, raw_l = GB.LAUNCHES - gb0, IK.LAUNCHES - raw0
    if dict(AP.AGG_PATH_STATS) != {"device-tail": AGG_BATCH} or gb_l <= 0:
        raise AssertionError(f"compacted aggregate: {AP.AGG_PATH_STATS}, "
                             f"{gb_l} group-by launches")
    with plain_versions():
        pagg = client.ft_aggregate_many("bm25", reqs)
    for req, k_, p_ in zip(reqs, agg, pagg):
        if k_.total != p_.total or k_.rows != p_.rows:
            raise AssertionError(f"compacted aggregate {req.query!r}: "
                                 f"{k_.rows} vs plain {p_.rows}")
    star = client.ft_aggregate("bm25", rt.AggregateRequest("*").group_by(
        "@grp", ("COUNT", [], "n")))
    n_star = sum(r["n"] for r in star.rows)
    if (n_star != seg.n_docs or star.total != seg.n_docs
            or GB.SINGLE_LAUNCHES <= 0):
        raise AssertionError(f"'*' GROUPBY @grp COUNT sums to {n_star}, "
                             f"{GB.SINGLE_LAUNCHES} B4 launches")
    qps = {fam: BATCH / s for fam, s in secs.items()}
    warm = warm_qps(client, batches, dev)
    log(f"phase lifecycle: (d) {AGG_BATCH} aggregate requests on the "
        f"device tail ({raw_l} raw B1 launches, {gb_l} B3 launches) == "
        f"plain; '*' GROUPBY @grp COUNT sums to {n_star} "
        f"({GB.SINGLE_LAUNCHES} B4 launches); qps of the counted run "
        + ", ".join(f"{f} {v:.1f}" for f, v in qps.items())
        + "; warm (best of 2) "
        + ", ".join(f"{f} {v:.1f}" for f, v in warm.items()))
    return dict(results=res, stats=stats, launches=launches,
                agg_launches=(raw_l, gb_l), b4=GB.SINGLE_LAUNCHES,
                err=err, qps=qps, warm_qps=warm)


def phase_life_rebuild(dev, docs, live, batches, cres) -> float:
    """Phase 11(e): a fresh index of the live docs, in corpus order,
    through `add_documents`; each family's results equal the compacted
    index's (`same_hits`).  Returns the ingest seconds."""
    import gc
    c2 = rt.Client(device=dev)
    ix2 = c2.ft_create("rebuild", bm25_fields())
    t0 = time.perf_counter()
    ix2.add_documents([docs[i] for i in live])
    torch.cuda.synchronize(dev)
    ingest_s = time.perf_counter() - t0
    n = 0
    for fam, qs in batches.items():
        for i, (a, b) in enumerate(zip(c2.ft_search_many("rebuild", qs,
                                                         k=K), cres[fam])):
            same_hits(b, a, f"compacted vs rebuild [{fam} {i}]")
            n += 1
    log(f"phase lifecycle: (e) rebuild of the {len(live)} live docs: "
        f"ingest {ingest_s:.2f}s; all {n} queries of the compacted index "
        f"== the rebuild's (same_hits)")
    c2.ft_dropindex("rebuild")
    del ix2, c2
    gc.collect()
    torch.cuda.empty_cache()
    return ingest_s


def new_doc(j: int) -> dict:
    """Phase 11(f)'s text: tokens no corpus doc holds."""
    return {"title": f"u{j}a u{j}b", "body": f"u{j}c u{j}d u{j}e",
            "cat": f"cat{j % 16:02d}", "grp": f"g{j % 1000:04d}",
            "price": float(j + 1)}


# each family's query on the tokens of new_doc(j)
NEW_FAMILIES = {
    "and2": lambda j: f"u{j}a u{j}b",
    "phrase": lambda j: f'"u{j}a u{j}b"',
    "and2_tag": lambda j: f"u{j}a u{j}b @cat:{{cat{j % 16:02d}}}",
    "and3": lambda j: f"u{j}a u{j}b u{j}c",
    "or2": lambda j: f"u{j}a|u{j}c",
    "not2": lambda j: f"u{j}a -u{j}z",
    "opt2": lambda j: f"u{j}a ~u{j}c",
    "fields2": lambda j: f"@title:u{j}a @body:u{j}c",
}


def phase_life_overwrite(client, ix, dev, docs, live) -> None:
    """Phase 11(f): `hset` 1,000 live keys with new text and 1,000 new
    keys, one query seals the second segment; new docs are found by their
    own tokens, no overwritten version is served, `ft_get` / `ft_mget`
    return the new fields."""
    rng = np.random.default_rng(31)
    over = rng.choice(live, 1000, replace=False)
    keys = [f"d{i}" for i in over] + [f"new{j}" for j in range(1000)]
    old_gids = {k: ix.doctable.get_by_key(k).gid for k in keys[:1000]}
    probe = over[:LIFE_B]
    old_q = {"and2": [" ".join(docs[i][1]["title"].split()[:2])
                      for i in probe],
             "phrase": ['"' + docs[i][1]["title"] + '"' for i in probe]}
    before = client.ft_search_many("bm25", old_q["phrase"], k=K)
    t0 = time.perf_counter()
    for j, key in enumerate(keys):
        client.hset(key, new_doc(j))
    client.ft_search_many("bm25", [NEW_FAMILIES["and2"](0)], k=K)
    torch.cuda.synchronize(dev)
    write_s = time.perf_counter() - t0
    s0, s1 = ix.segments if len(ix.segments) == 2 else (None, None)
    if s0 is None or s1.n_docs != 2000 or s0.n_deleted != 1000:
        raise AssertionError(f"overwrites: {len(ix.segments)} segments")
    pick = list(range(0, 2000, 2000 // LIFE_B))[:LIFE_B]
    batches = {f: [fn(j) for j in pick] for f, fn in NEW_FAMILIES.items()}
    res, stats, launches, _s = served_families(client, "bm25", batches,
                                               dev)
    for fam, rs_ in res.items():
        for j, r in zip(pick, rs_):
            if r.total != 1 or [h.key for h in r.hits] != [keys[j]]:
                raise AssertionError(f"new doc {keys[j]} [{fam}]: "
                                     f"{r.total} {r.hits}")
    after = {f: client.ft_search_many("bm25", qs, k=K)
             for f, qs in old_q.items()}
    overset = set(keys[:1000])
    for n, (i, q, a) in enumerate(zip(probe, old_q["and2"],
                                      after["and2"])):
        key = f"d{i}"
        loc = s0.gid_to_local[old_gids[key]]
        if key in [h.key for h in a.hits] or s0.alive_np[loc] or (
                n < 16 and a.total != len(live_and2_docs(s0, ix, q))):
            raise AssertionError(f"overwritten {key} survives [{q!r}]")
    for i, b, a in zip(probe, before, after["phrase"]):
        key = f"d{i}"
        gone = len(overset & {h.key for h in b.hits})
        if key in [h.key for h in a.hits] or (
                b.total <= K and a.total != b.total - gone):
            raise AssertionError(f"overwritten {key} survives its phrase")
    for j, key in enumerate(keys):
        if client.ft_get("bm25", key) != new_doc(j):
            raise AssertionError(f"ft_get {key}: {client.ft_get('bm25', key)}")
    got = client.ft_mget("bm25", *[keys[j] for j in pick])
    if got != [new_doc(j) for j in pick]:
        raise AssertionError("ft_mget does not return the new fields")
    log(f"phase lifecycle: (f) hset {len(keys)} docs (1,000 overwrites) and "
        f"the sealing query in {write_s:.2f}s; second segment "
        f"{s1.n_docs} docs; {LIFE_B} queries a family ({stats}, B1 "
        f"launches {launches[0]}, B2 {launches[2]}) find each new doc by "
        f"its own tokens; no overwritten version served (its old copy "
        f"dead, in no hit of {LIFE_B} and2 and {LIFE_B} title-phrase "
        f"queries of its old text; 16 and2 totals == numpy over the live "
        f"docs, the phrases' totals down by the overwritten docs); "
        f"ft_get of all {len(keys)} and ft_mget of {LIFE_B} return the "
        f"new fields")


def phase_lifecycle(dev, main) -> dict:
    """Phase 11 (see the docstring) on the main path's 1M-doc index."""
    client, ix, qt = main["client"], main["ix"], main["qt"]
    docs = main.pop("docs")
    batches = {fam: [fn(qt, i) for i in range(BATCH)]
               for fam, fn in FAMILIES.items()}
    small = {fam: qs[:LIFE_B] for fam, qs in batches.items()}
    t0 = time.perf_counter()
    ck = phase_life_checkpoint(client, ix, batches, dev)
    dirty = phase_life_dirty(client, ix, small, dev)
    comp = phase_life_compact(client, ix, dev)
    served = phase_life_served(client, ix, batches, dev)
    log("phase lifecycle: (b)/(d) qps a family, dirty (window program, "
        f"{LIFE_B} queries) -> compacted (kernels, batch {BATCH}, warm): "
        + ", ".join(f"{f} {dirty['qps'][f]:.1f} -> "
                    f"{served['warm_qps'][f]:.1f}" for f in batches))
    dead = {i for i in range(1, N_DOCS, 5)} | set(
        list(range(3, N_DOCS, 5))[:N_DOCS * 6 // 100])
    live = np.array([i for i in range(N_DOCS) if i not in dead])
    rebuild_s = phase_life_rebuild(dev, docs, live, batches,
                                   served.pop("results"))
    log(f"phase lifecycle: (c)/(e) compaction {comp['compact_s']:.2f}s "
        f"against the rebuild's ingest {rebuild_s:.2f}s "
        f"({rebuild_s / comp['compact_s']:.1f}x)")
    phase_life_overwrite(client, ix, dev, docs, live)
    out = {"checkpoint": ck, "dirty": dirty, "compact": comp,
           "served": served, "rebuild_s": rebuild_s,
           "seconds": time.perf_counter() - t0}
    log("phase lifecycle: json " + json.dumps(out))
    return out


def main():
    smi = phase_card()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    phase_build()
    err3, err3_raw = phase_kernel_vs_plain(dev)
    err3_phrase = phase_phrase_vs_plain(dev)
    err_gb3 = phase_groupby_vs_plain(dev)
    err_sums3, err_mm3 = phase_single_groupby_vs_plain(dev)
    main = phase_main_path(dev, N_DOCS, BATCH)
    agg = phase_aggregate(main["client"], main["ix"], dev)
    star = phase_agg_star(main["client"], main["ix"], dev)
    mm = phase_agg_minmax(main["client"], main["ix"], dev)
    single = phase_single_groupby_times(main["ix"], dev, mm["windows"])
    phase_cursor(main["client"], main["ix"], dev)
    vec = phase_vector(dev)
    phase_hybrid(dev, vec.pop("index"))
    del vec
    torch.cuda.empty_cache()
    phase_ann(dev)
    phase_geo(dev)
    phase_cold(dev, main)
    life_err = phase_lifecycle(dev, main)["served"]["err"]
    k_ms, p_ms, k_err, k_b = main["times"]["intersect"]
    wk_ms, wp_ms, wk_err, wk_b = main["times"]["intersect_wide"]
    pk_ms, pp_ms, pk_err, pk_b = main["times"]["phrase"]
    jax_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "redisearch_tpu") + os.sep
    loaded = [m for m, mod in list(sys.modules.items())
              if m == "jax" or m.startswith("jax.")
              or m == "redisearch_tpu" or m.startswith("redisearch_tpu.")
              or (getattr(mod, "__file__", None) or "").startswith(jax_dir)]
    if loaded:
        raise AssertionError(f"JAX-side modules were imported: {loaded}")
    log("phase modules: no jax module and no module file under "
        "redisearch_tpu/ was loaded")

    def rec(name, source, replaces, launches, err, ms, plain_ms, b,
            library_ms):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": b, "bound_by": "bytes", "library_ms": library_ms}

    ss, sm = single["groupby_sums"], single["groupby_minmax"]
    log(smi)
    log(json.dumps({"kernels": [
        rec("intersect", KERNEL_SRC, KERNEL_REPLACES, main["launches"],
            max(err3, main["err"]["intersect"], life_err["intersect"],
                k_err), k_ms, p_ms, k_b, None),
        rec("intersect_wide", KERNEL_SRC, KERNEL_REPLACES,
            main["w_launches"], max(err3, main["err"]["intersect"],
                                    life_err["intersect"], wk_err),
            wk_ms, wp_ms, wk_b, None),
        rec("phrase", PHRASE_SRC, PHRASE_REPLACES, main["p_launches"],
            max(err3_phrase, main["err"]["phrase"], life_err["phrase"],
                pk_err), pk_ms, pp_ms, pk_b, None),
        rec("intersect_raw", KERNEL_SRC, KERNEL_REPLACES,
            agg["raw_launches"], max(err3_raw, agg["err_raw"]),
            agg["raw_ms"][0], agg["raw_ms"][1], agg["raw_ms"][2], None),
        rec("groupby_sums_batch", GB_SRC, GB_REPLACES, agg["gb_launches"],
            max(err_gb3, agg["err_gb"]), *agg["gb_ms"]),
        rec("groupby_sums", GB_SRC, SUMS_REPLACES, star["launches"],
            max(err_sums3, ss[4]), *ss[:4]),
        rec("groupby_minmax", GB_SRC, MINMAX_REPLACES, mm["launches"],
            max(err_mm3, sm[4]), *sm[:4])]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--save-groups"] and len(sys.argv) == 3:
        save_b1_groups(sys.argv[2])
    elif len(sys.argv) > 1:
        raise SystemExit(__doc__)
    else:
        main()

"""Drive the torch port's main path once on one CUDA card, and check it.

    python3 chip_smoke.py
    python3 chip_smoke.py --save-groups PATH   # only: save_b1_groups

Phases, each reported on its own lines; any failure raises and the
script exits non-zero:

1. card: no CUDA device is a failure; prints the device, nvidia-smi's
   name and power limit, and the english stemmer in effect.
2. build: compiles `redisearch_tpu_torch/csrc/intersect.cu`,
   `csrc/phrase.cu`, `csrc/groupby.cu` and `csrc/probes.cu` with nvcc for sm_90a (one nvcc
   each, started together) and prints each one's seconds and ptxas'
   register/spill report.
3. kernel vs plain: random posting windows (drawn on the card from a
   seeded torch generator, all queries of a case at once; the draw's
   seconds are printed) at the serving buckets (pivot 2048/8192/32768,
   members up to 131072), the AND/NOT/OPT/OR families,
   tag-aux and dense-tag plans, k = 1/16/64, multi-phase ORs, and
   batches larger than the kernel's grid; the cases of
   benchmarks/intersect_crosscheck.py the others miss (one slot; NOT,
   union and OPT over tag aux slots; a 3-value dense predicate, one
   under a union pivot, two beside an OPT member); the wide route's
   pivots
   (65,536 and 131,072 lanes: or2, and2 with both slots wide, a NOT
   member, a batch past the grid); score ties across a tile boundary
   of the narrow, mid and wide block shapes (batches of 1,200, 320 and
   16 queries, which pick those shapes), a wide pivot against a
   131,072-lane member range and phases of at most k matches.  Lane for lane
   equal docs, bit-identical scores, equal counts, in top-k mode and,
   where the pivot is within 32,768 lanes, in raw mode (`raw=True`).
   Then the phrase kernel against `phrase_plain`, top-k and raw, on
   random posting and position-key windows (drawn on the card too;
   W0/PW 2048..131072, T = 2..4, slop 0-3, k = 1/16/64, repeated
   terms, clamped keys, a 1024 stride, batches larger than its grid):
   lane for lane equal, scores bit-identical.  Then the group-by kernel against
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
3b. probes: the four kernels of `csrc/probes.cu` (the Hopper
   counterparts of the TPU probe scripts in `benchmarks/`:
   `probe_floor`, `probe_gwin`, `probe_gcols`, `probe_variant`), every
   arm of the port's four scripts (`redisearch_tpu_torch/bench/`) at
   their own B and shapes, on seeded random inputs (grid_floor's d and
   f drawn from seed 1, not its zeros), and grid_floor's and gstep2's
   arms again at B1's batch of 8,192 (8,192 / G groups, above the
   card's 132 SMs), each held lane for lane against its plain version:
   exact, but gstep's truncated f32 sums within 2; kernel_probe's
   `full` arm (B1) exact too.  Then edge cases the scripts' inputs
   miss: kernel_probe's windows with random, tying scores, unaligned
   starts, short pivots and qmasks no mask meets at k = 1, 16 and 128,
   gstep's live offsets past, at and before its windows, and the
   persistent kernels (probe_floor, probe_gcols) at B = 3, 4,613 and
   65,536 (clamped gcols starts).  The launch counts are zeroed just
   before that run and read just after: every probe kernel must have
   launched.  Printed: the TMA ring each ring arm gets (stages, tile
   rows, shared bytes, blocks an SM, registers), each arm's device and
   wall us a query beside its bytes bound; each kernel's record in the
   `kernels` line is its arm named in PROBE_RECORDS (probe_floor's and
   probe_gcols' at B = 8,192), with the library call its arms name
   (`Arm.library`) and that call's distance from the plain version.
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
13. the wire (run after 6b, before phase 7), on the same 1M-doc index:
   the port's RESP server (`server.Server` on phase 4's client, its
   event loop on a thread of this process; the RESP client is
   `bench/workloads.py`'s, which the bench's wire section uses too); 64
   asyncio connections send
   8,192 `FT.SEARCH ... NOCONTENT WITHSCORES` (the first 1,024 queries
   of each of the eight families, interleaved), three timed passes:
   every reply's total, ids, order and scores must equal phase 4's
   `ft_search_many` result for the query (`same_hits`; the bit-for-bit
   count is printed); the native RESP parser must have served.  Then
   64 FT.SEARCH with content (fields equal to the doc table's) and 64
   FT.AGGREGATE (32 of phase 6's request, 32 `*` GROUPBY @grp COUNT,
   which must sum to 1,000,000), each equal to `Client.ft_aggregate` of
   the same parsed request.  B1, B2 and the group-by kernels (B3/B4)
   must have launched during the phase.  Printed: wire QPS (median of
   the passes, host clock), the micro-batch sizes formed, a traced
   pass's device busy and idle share, and the RESP layer's own time
   (native parse of a pass's bytes, reply format and encode).
14. the command surface on the card, on the same index: FT.INFO
   (num_docs, num_records the segments' nnz, inverted_sz_mb their
   `memory_bytes`); FT.PROFILE SEARCH of one query a family (results
   equal to `ft_search`, the root counter the total, and2's counters
   equal to numpy counts over the host-copied postings; clocks read
   after a synchronize); FT.EXPLAINSCORE of the top hit of 64 queries
   (within 1e-5 relative of the served score); HIGHLIGHT and SUMMARIZE
   on 64 hits (equal to `highlight_field` / `summarize_field` of the same
   docs); FT.SPELLCHECK of 64 misspelt vocabulary words (equal to the
   vocabulary's distance-1 terms ranked by doc frequency); FT.SUGADD of
   100,000 suggestions and 1,000 FT.SUGGET prefix queries, timed (16
   equal to a brute force); FT.TAGVALS cat (16 values); FT.CONFIG SET
   TIMEOUT / ON_TIMEOUT with FT.DEBUG's TIMEOUT_AFTER_N (the first 5
   hits and the warning, or TimeoutError_); ON_OOM return and fail on
   the card through a patched `torch.cuda.mem_get_info`; HAMMING over
   8-byte payloads and a registered custom scorer on a 10,000-doc index,
   ids and scores equal to the same build on the CPU.
7. vector path (FLAT search; no Pallas kernel lies on it, so its ops
   are torch ops: a GEMM, elementwise masks and `torch.topk`).  First
   tests/test_units.py::test_two_phase_knn_clustered's input (4,096 x 64
   f32, 16 queries near one center, k 10): every distance of
   `knn_batch` and `knn` within 3e-5 of float64 on the card (the max
   error printed beside the card's name).  Then
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
15. distribution (run after 7b, before phase 8), on the one card:
   `parallel.dist.ShardedIndex.build` of phase 4's 1M-doc index over
   `make_mesh(4)` (4 slots, round-robin over the cards) and over
   `make_mesh(4, n_dcn=2)` (build seconds, docs and device MiB a
   shard, `torch.cuda.device_count()` printed).  32 queries of each of
   the eight families: `search(q, num=10)` must equal the host merge by
   (-score, gid) of the four shards' own `SearchIndex` views (totals,
   ids and order exact, scores within 1e-6 relative: BM25 is
   shard-local, as on the reference coordinator), the 2D mesh's result
   exactly, and `search_many` of the family the same; 64 DISMAX and 64
   SORTBY @price queries must equal the single index's.  Phase 7's
   500k x 384 index over 4 slots: 64 KNN 10 queries equal to the single
   index (ids, distances within 1e-5), their `search_many` equal, 32
   RRF hybrids with a DISMAX text branch equal to the single index's.
   `dist_aggregate` of COUNT/SUM/AVG and of MIN/MAX/COUNT by @grp over
   `*` and @cat:{cat03} against `run_aggregate` on the single index
   (counts, MIN and MAX exact, SUM and AVG within 1e-5 relative), with
   the launch counters zeroed just before each kind and read just
   after: the sums kind must launch B4, the min/max kind B5.
   `kmeans_step_sharded` on 1M x 100 seeded rows over 4 slots with
   1,024 centroids within 1e-4 relative of `kmeans_step` on the whole
   (rows assigned differently printed).  `dryrun_multichip(4)` on the
   card.  Printed beside nvidia-smi's name and power limit: QPS a
   family of `search` and `search_many` (32 queries) against the single
   index's window program (`ix.search`) and its `ft_search_many` of the
   same queries, a query's shard-program and merge ms, a traced
   `search_many`'s idle share, KNN and hybrid QPS, ms an aggregate
   request, the k-means step's ms.
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
   served (in 256 and2 queries, 16 of them with totals equal to numpy
   over the live docs, and 256 title phrases of its old text), `ft_get`
   and `ft_mget` return the new fields.  QPS on the
   dirty and the compacted index are printed.
16. the port's bench (run after 11, before 12; at most about a minute):
   `redisearch_tpu_torch/bench/run.py`'s six sections (text, fknn,
   knn, ann: bench.py's sections; wire and cold: benchmarks/
   wire_bench.py's and cold_bench.py's) in this process at bench.py's
   BENCH_SMOKE shapes (20,000 docs, 100,000 vectors), one measurement of
   each number; every section must pass, every number carry its parity
   check (FT.SEARCH, FT.AGGREGATE and FT.HYBRID against their plain
   recomputation, KNN and IVF recall against float64 on the card, every
   wire reply against `ft_search_many`, every cold result against the
   hot index) and every FT.SEARCH family ride a kernel.
17. the bench scripts' checks (after 16): `bench/device_smoke.py
   --compare`'s comparison (benchmarks/tpu_smoke.py's 64-doc digest on
   the card and on the CPU: keys, order and totals equal, numbers within
   1e-4), `bench/intersect_micro.py` at one point (B = 512, (2048,
   8192), k 16 and 1) and `bench/phrase_ab.py` at one shape ((2048,
   2048), fill 0.5, tf 2: B2 top-k and raw, B1's matched and2), each
   kernel held lane for lane against its plain version, then timed.
12. the module check (no jax, no module file under `redisearch_tpu/` or
   `benchmarks/`),
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

import importlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

import redisearch_tpu_torch as rt
from redisearch_tpu_torch.agg import pipeline as AP
from redisearch_tpu_torch.bench import probes as PB
# device time of one call of fn, in ms: CUDA events around 20 calls
# enqueued while the card spins in `torch.cuda._sleep`
from redisearch_tpu_torch.bench.ab import device_ms as time_ms
# bench.py's data, query families and the checks against plain, shared
# with the port's bench (`python3 -m redisearch_tpu_torch.bench.run`)
from redisearch_tpu_torch.bench.workloads import (
    ANN_D, ANN_K, ANN_N, ANN_NLIST, ANN_NPROBES, ANN_Q, ANN_REPS, FAMILIES,
    FKNN_D, FKNN_K, FKNN_N, HYB_B, HYB_LIMIT, HYB_ROUNDS, HYB_W,
    K, SCORE_RTOL, agg_request_fn, ann_corpus, ann_truth,
    bm25_fields, check_against_plain, check_fknn, device_busy_us,
    fknn_corpus, fknn_families, fknn_fields, hybrid_queries,
    intersect_bytes, make_corpus, nbytes, phrase_bytes, plain_results,
    plain_versions, recall_of, same_fusion, same_knn_hits, star_request,
    start_server, wire_run)
from redisearch_tpu_torch.ops import _build
from redisearch_tpu_torch.ops import groupby as GB
from redisearch_tpu_torch.ops import intersect as IK
from redisearch_tpu_torch.ops import lvq as TL
from redisearch_tpu_torch.ops import text as T
from redisearch_tpu_torch.ops import vector as V
from redisearch_tpu_torch.parallel import dist as D
from redisearch_tpu_torch.query import engine as E

N_DOCS = 1_000_000
BATCH = 8192
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
            if any(w in line for w in ("registers", "spill", "smem",
                                       "entry function")):
                log(f"phase build: {name}: ptxas: {line.strip()}")


# ---------------------------------------------------------------- phase 3
INT32_MAX = IK.INT32_MAX


def rand_ints(gen, lo: int, hi: int, size, dtype=torch.int32):
    """Integers in [lo, hi) from `gen`, on its device."""
    return torch.randint(lo, hi, size, generator=gen, device=gen.device,
                         dtype=dtype)


def rand_unit(gen, size):
    """Uniform floats in [0, 1) from `gen`, on its device."""
    return torch.rand(size, generator=gen, device=gen.device)


def sorted_unique_rows(vals, width: int):
    """Per row of `vals` (int32, INT32_MAX pads), its distinct values
    ascending in the first `width` columns (INT32_MAX after them), and
    how many of them there are."""
    v = vals.sort(dim=1).values
    dup = torch.zeros_like(v, dtype=torch.bool)
    dup[:, 1:] = v[:, 1:] == v[:, :-1]
    v = v.masked_fill(dup, INT32_MAX).sort(dim=1).values[:, :width]
    return v.contiguous(), (v < INT32_MAX).sum(1)


def make_windows(gen, B, Ws, n_docs=2_000_000, overlap=0.5, full=False):
    """Random doc-sorted posting windows sharing a per-query doc pool (so
    slots genuinely intersect), at arbitrary offsets of flat arrays —
    the layout of tests/test_pallas_interpret.py's _make_windows.  Each
    window's live length is drawn from [W/2, W], or is W with `full`;
    its docs are the smallest `live` distinct ones of the pool's docs
    (2 max(Ws) draws) kept with probability `overlap` and `live` fresh
    draws; a window starts 0-127 lanes past the end of the last one's
    bucket.  Drawn from the torch generator `gen` on its device, a slot
    at a time for all B queries at once; the arrays stay there."""
    T, dev = len(Ws), gen.device
    total = B * sum(w + 128 for w in Ws) + 4096
    doc_ids = torch.full((total,), INT32_MAX, dtype=torch.int32, device=dev)
    freqs = torch.zeros(total, dtype=torch.float32, device=dev)
    masks = torch.zeros(total, dtype=torch.int32, device=dev)
    dl = (torch.randn(total, generator=gen, device=dev) * 6.0 + 24.0).abs() \
        + 1.0
    meta = torch.zeros((B, 3 * T), dtype=torch.int32, device=dev)
    fmeta = torch.zeros((B, T + 1), dtype=torch.float32, device=dev)
    pool = rand_ints(gen, 0, n_docs, (B, 2 * max(Ws))).sort(dim=1).values
    distinct = torch.ones_like(pool, dtype=torch.bool)
    distinct[:, 1:] = pool[:, 1:] != pool[:, :-1]
    sizes = (torch.tensor(Ws, device=dev)[None, :]
             + rand_ints(gen, 0, 128, (B, T), torch.int64)).reshape(-1)
    starts = (sizes.cumsum(0) - sizes).reshape(B, T)
    for t, W in enumerate(Ws):
        live = (torch.full((B,), W, device=dev) if full else
                rand_ints(gen, max(1, W // 2), W + 1, (B,), torch.int64))
        col = torch.arange(W, device=dev)[None, :]
        shared = pool.masked_fill(
            ~distinct | (rand_unit(gen, pool.shape) >= overlap), INT32_MAX)
        extra = rand_ints(gen, 0, n_docs, (B, W)).masked_fill(
            col >= live[:, None], INT32_MAX)
        docs, n = sorted_unique_rows(torch.cat([shared, extra], 1), W)
        live = torch.minimum(live, n)
        idle = col >= live[:, None]
        # the lanes past `live` are the gap before the next window: they
        # keep the arrays' fillers
        at = starts[:, t, None] + col
        doc_ids[at] = docs
        freqs[at] = rand_ints(gen, 1, 8, (B, W)).float().masked_fill(idle, 0)
        masks[at] = torch.where(rand_unit(gen, (B, W)) < 0.9, 3, 4).to(
            torch.int32).masked_fill(idle, 0)
        meta[:, t], meta[:, T + t], meta[:, 2 * T + t] = starts[:, t], live, 3
    fmeta[:, :T] = 0.5 + 3.5 * rand_unit(gen, (B, T))
    fmeta[:, T] = 24.0
    return meta, fmeta, doc_ids, freqs, masks, dl


def kernel_cases(gen, B=48):
    """(label, args on `gen`'s device, plan kwargs) at the serving
    buckets, B queries each."""
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
        args = make_windows(gen, B, Ws)
        out.append((label, args, dict(T=len(Ws), Ws=Ws, groups=groups,
                                      k=k)))
    # more queries than the kernel's grid: blocks serve q, q + grid, ...
    # and reuse their scratch row and shared state
    B_big = IK._MAX_GRID + 517
    for label, Ws, groups in (
            ("and2-gridstride", (2048, 2048), ((R, (0,)), (R, (1,)))),
            ("or2-gridstride", (2048, 2048), ((R, (0, 1)),))):
        args = make_windows(gen, B_big, Ws)
        out.append((label, args, dict(T=2, Ws=Ws, groups=groups, k=16)))
    # a TAG member slot streamed from an aux doc-window array, and dense
    # posting-aligned code predicates (REQ with 2 values, NOT)
    Ws = (2048, 8192)
    out.append(("tag-aux", with_aux(gen, make_windows(gen, B, Ws), Ws, (1,)),
                dict(T=2, Ws=Ws, groups=((R, (0,), -1), (R, (1,), 0)),
                     k=16)))
    dense = ((R, 0, 2), (N, 1, 1))
    out.append(("dense-tag", with_dense(gen, make_windows(gen, B, Ws),
                                        dense),
                dict(T=2, Ws=Ws, groups=((R, (0,), -1), (R, (1,), -1)),
                     k=16, dense=dense)))
    return (out + crosscheck_cases(gen, B) + wide_kernel_cases(gen)
            + tile_kernel_cases(gen))


def with_aux(gen, args, Ws, aux_slots):
    """`args` with the slots `aux_slots` moved to one aux doc-window
    array (tag postings: docs only), each window the distinct docs of
    W/2..W draws, one lane apart."""
    meta, fmeta, d, f, m, dl = args
    meta, dev = meta.clone(), meta.device
    B, T = meta.shape[0], len(Ws)
    aux = torch.full((B * sum(Ws[t] + 1 for t in aux_slots) + 4096,),
                     INT32_MAX, dtype=torch.int32, device=dev)
    at = 0
    for t in aux_slots:
        W = Ws[t]
        col = torch.arange(W, device=dev)[None, :]
        draws = rand_ints(gen, 0, 2_000_000, (B, W)).masked_fill(
            col >= rand_ints(gen, max(1, W // 2), W + 1, (B, 1)), INT32_MAX)
        docs, n = sorted_unique_rows(draws, W)
        first = at + torch.arange(B, device=dev) * (W + 1)
        aux[first[:, None] + col] = docs
        meta[:, t], meta[:, T + t] = first, n
        at += B * (W + 1)
    return meta, fmeta, d, f, m, dl, aux


def with_dense(gen, args, dense):
    """`args` with a posting-aligned int32 code column (codes 0..7) and
    its query values (-1..9; -2, unbound, in a third of the last slots of
    a multi-value predicate) and leaf constant per dense predicate."""
    meta, fmeta, d, f, m, dl = args
    B = meta.shape[0]
    cols, qs, fs = [], [meta], [fmeta]
    for _flag, _src, nv in dense:
        cols.append(rand_ints(gen, 0, 8, (d.shape[0],)))
        q = rand_ints(gen, -1, 10, (B, nv))
        if nv > 1:
            q[rand_unit(gen, B) < 0.3, nv - 1] = -2
        qs.append(q)
        fs.append(0.5 + 3.5 * rand_unit(gen, (B, 1)))
    return (torch.cat(qs, 1), torch.cat(fs, 1), d, f, m, dl, *cols)


def crosscheck_cases(gen, B=48):
    """benchmarks/intersect_crosscheck.py's cases that the serving-bucket
    cases above miss: one slot; NOT, union and OPT over tag aux slots
    (its AUX_CASES); a 3-value dense predicate, a dense predicate under a
    union pivot and two beside an OPT member (its DENSE_CASES)."""
    R, N, O = IK.REQ, IK.NOT, IK.OPT
    out = [(label, make_windows(gen, B, Ws),
            dict(T=1, Ws=Ws, groups=((R, (0,)),), k=k))
           for label, Ws, k in (("one-slot", (2048,), 16),
                                ("one-slot-k1", (8192,), 1))]
    for label, Ws, groups, aux_slots in (
            ("and-nottag", (2048, 8192), ((R, (0,), -1), (N, (1,), 0)),
             (1,)),
            ("and+tagor", (2048, 4096, 4096),
             ((R, (0,), -1), (R, (1, 2), 0)), (1, 2)),
            ("and2+opttag", (2048, 8192, 8192),
             ((R, (0,), -1), (R, (1,), -1), (O, (2,), 0)), (2,))):
        out.append((label, with_aux(gen, make_windows(gen, B, Ws), Ws,
                                    aux_slots),
                    dict(T=len(Ws), Ws=Ws, groups=groups, k=16)))
    for label, Ws, groups, dense in (
            ("and2+dor3", (2048, 8192), ((R, (0,)), (R, (1,))),
             ((R, 0, 3),)),
            ("or2+dense", (2048, 2048), ((R, (0, 1)),), ((R, 0, 1),)),
            ("opt+2dense", (2048, 8192), ((R, (0,)), (O, (1,))),
             ((R, 0, 1), (N, 1, 1)))):
        out.append((label, with_dense(gen, make_windows(gen, B, Ws), dense),
                    dict(T=2, Ws=Ws, groups=groups, k=16, dense=dense)))
    return out


def wide_kernel_cases(gen):
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
        out.append((label, make_windows(gen, B, Ws),
                    dict(T=2, Ws=Ws, groups=groups, k=k)))
    Ws = (65536, 2048)
    args = make_windows(gen, 8, Ws)
    pick = rand_ints(gen, 0, 8, (IK._MAX_GRID + 517,), torch.int64)
    out.append(("wide-or2-gridstride", (args[0][pick], args[1][pick])
                + args[2:], dict(T=2, Ws=Ws, groups=((R, (0, 1)),), k=16)))
    return out


def with_tie_band(args, lo, hi):
    """Every query's pivot (slot 0) lanes [lo, hi) get one score (tf 7,
    doc length 24, mask-valid; the other lanes tf 1), above every other
    lane: a tie that straddles a tile boundary inside [lo, hi)."""
    meta, fmeta, d, f, m, dl = (a.clone() for a in args)
    T = meta.shape[1] // 3
    s_, n = meta[:, 0].long(), meta[:, T].long()
    if bool((n < hi).any()):
        raise AssertionError("tie band past the live lanes")
    col = torch.arange(int(n.max()), device=meta.device)[None, :]
    f[(s_[:, None] + col)[col < n[:, None]]] = 1.0
    band = s_[:, None] + torch.arange(lo, hi, device=meta.device)[None, :]
    f[band] = 7.0
    dl[band] = 24.0
    m[band] = 3
    return meta, fmeta, d, f, m, dl


def tile_kernel_cases(gen):
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
        args = with_tie_band(make_windows(gen, B, Ws, full=True), 2030,
                             2070)
        out.append((label, args, dict(T=2, Ws=Ws, groups=groups, k=k)))
    Ws = (65536, 131072)
    out.append(("wide-member-131072", make_windows(gen, 8, Ws,
                                                       full=True),
                dict(T=2, Ws=Ws, groups=((R, (0,)), (R, (1,))), k=16)))
    Ws = (8192, 2048)
    meta, *rest = make_windows(gen, 48, Ws)
    meta[:, 2] = rand_ints(gen, 0, 40, (48,))     # pivot lens, some 0
    out.append(("count-le-k", (meta, *rest),
                dict(T=2, Ws=Ws, groups=((R, (0,)), (O, (1,))), k=64)))
    return out + shape_kernel_cases(gen)


def shape_kernel_cases(gen):
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
        args = with_tie_band(make_windows(gen, 1200, Ws, full=True), 240,
                             270)
        out.append((label, args, dict(T=2, Ws=Ws, groups=groups, k=k)))
    meta, *rest = make_windows(gen, 1200, Ws)
    meta[:, 2] = rand_ints(gen, 0, 40, (1200,))   # pivot lens, some 0
    out.append(("narrow-count-le-k", (meta, *rest),
                dict(T=2, Ws=Ws, groups=((R, (0,)), (O, (1,))), k=64)))
    for label, Ws, groups, k in (
            ("mid-or2-8192x2048", (8192, 2048), ((R, (0, 1)),), 16),
            ("mid-not-32768x2048", (32768, 2048), ((R, (0,)), (N, (1,))),
             64),
            ("mid-opt-8192x8192", (8192, 8192), ((R, (0,)), (O, (1,))), 16)):
        out.append((label, make_windows(gen, 320, Ws),
                    dict(T=2, Ws=Ws, groups=groups, k=k)))
    Ws = (4096, 2048)
    args = with_tie_band(make_windows(gen, 320, Ws, full=True), 2030, 2070)
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
    gen = torch.Generator(device=dev).manual_seed(7)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cases = kernel_cases(gen, B)
    torch.cuda.synchronize()
    log(f"phase kernel-vs-plain: {len(cases)} cases drawn on the card in "
        f"{time.perf_counter() - t0:.2f}s")
    err, err_raw = 0.0, 0.0
    for label, args, kw in cases:
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


def region_starts(gen, B: int, widths, skip=()):
    """Where each of B queries' windows starts in a flat array: the
    windows lie query by query, slot by slot, each 0-127 lanes past the
    end of the last one's region of width + 128; a slot in `skip` takes
    no region (its start is 0).  [B, len(widths)] int64."""
    T = len(widths)
    on = torch.tensor([t not in skip for t in range(T)], device=gen.device)
    pre = rand_ints(gen, 0, 128, (B, T), torch.int64) * on
    size = (torch.tensor(widths, device=gen.device) + 128) * on + pre
    flat = size.reshape(-1)
    return ((flat.cumsum(0) - flat).reshape(B, T) + pre) * on


def make_phrase_windows(gen, B, Ws, PWs, stride=64, n_docs=2_000_000,
                        clamp=False, repeat=False):
    """Random phrase inputs (tests/test_torch_phrase.py's _make_phrase,
    drawn for all B queries at once from the torch generator `gen`, on
    its device): per query and slot a doc-sorted posting window (the
    smallest of W/4..W distinct docs of a per-query pool of max(Ws)
    draws, each kept with probability 0.6, and fresh draws) and a
    sorted position-key window (doc * stride + pos, 1-2 random
    positions a doc) at arbitrary offsets of flat arrays, INT32_MAX
    past the live length.  Half the docs common to every slot get an
    in-order run with gaps of 0-2 positions, so chains of every slop
    match.  clamp: positions past stride - 1 are clamped there (keys
    repeat within a term, as on a pos_clamped segment).  repeat: slot 1
    reads slot 0's windows (a repeated term).  Keys past PW are cut."""
    T, dev = len(Ws), gen.device
    big = 2**62                     # pads the int64 keys
    # each window takes at most its bucket + 255 (offset and gap), and
    # the last one's bucket stays inside the array: no start is clamped
    n_post = B * sum(w + 256 for w in Ws) + max(Ws) + 4096
    n_keys = B * sum(p + 256 for p in PWs) + max(PWs) + 4096
    doc_ids = torch.full((n_post,), INT32_MAX, dtype=torch.int32, device=dev)
    freqs = torch.zeros(n_post, dtype=torch.float32, device=dev)
    masks = torch.zeros(n_post, dtype=torch.int32, device=dev)
    dl = (torch.randn(n_post, generator=gen, device=dev) * 6.0 + 24.0).abs() \
        + 1.0
    keys = torch.full((n_keys,), INT32_MAX, dtype=torch.int32, device=dev)
    meta = torch.zeros((B, 5 * T), dtype=torch.int32, device=dev)
    fmeta = torch.zeros((B, T + 1), dtype=torch.float32, device=dev)
    pool = rand_ints(gen, 0, n_docs, (B, max(Ws))).sort(dim=1).values
    distinct = torch.ones_like(pool, dtype=torch.bool)
    distinct[:, 1:] = pool[:, 1:] != pool[:, :-1]
    slot_docs, lives = [], []
    for W in Ws:
        live = rand_ints(gen, max(1, W // 4), W + 1, (B,), torch.int64)
        col = torch.arange(W, device=dev)[None, :]
        shared = pool.masked_fill(~distinct | (rand_unit(gen, pool.shape)
                                               >= 0.6), INT32_MAX)
        extra = rand_ints(gen, 0, n_docs, (B, W)).masked_fill(
            col >= live[:, None], INT32_MAX)
        docs, n = sorted_unique_rows(torch.cat([shared, extra], 1), W)
        live = torch.minimum(live, n)
        slot_docs.append(docs.masked_fill(col >= live[:, None], INT32_MAX))
        lives.append(live)
    # the docs of slot 0 in every slot (INT32_MAX pads sort last)
    d0 = slot_docs[0]
    common = torch.arange(Ws[0], device=dev)[None, :] < lives[0][:, None]
    for docs in slot_docs[1:]:
        at = torch.searchsorted(docs, d0).clamp_max(docs.shape[1] - 1)
        common &= docs.gather(1, at) == d0
    seeded = common & (rand_unit(gen, d0.shape) < 0.5)
    p0 = rand_ints(gen, 0, stride - 3 * T, d0.shape, torch.int64)
    gaps = rand_ints(gen, 0, 3, d0.shape + (T,), torch.int64).cumsum(2)
    skip = (1,) if repeat else ()
    at_p = region_starts(gen, B, Ws, skip)
    at_k = region_starts(gen, B, PWs, skip)
    for t, (W, PW) in enumerate(zip(Ws, PWs)):
        if t in skip:
            continue
        docs, live = slot_docs[t], lives[t]
        col = torch.arange(W, device=dev)[None, :]
        idle = col >= live[:, None]
        at = at_p[:, t, None] + col
        doc_ids[at] = docs
        freqs[at] = rand_ints(gen, 1, 8, (B, W)).float().masked_fill(idle, 0)
        masks[at] = torch.where(rand_unit(gen, (B, W)) < 0.9, 3, 4).to(
            torch.int32).masked_fill(idle, 0)
        # one or two random positions a live doc, and the seeded runs
        hi = stride + 40 if clamp else stride
        twice = rand_unit(gen, (B, W)) < 0.5
        dd = torch.cat([docs.long().masked_fill(idle, -1),
                        docs.long().masked_fill(idle | ~twice, -1),
                        d0.long().masked_fill(~seeded, -1)], 1)
        pos = torch.cat([rand_ints(gen, 0, hi, (B, 2 * W), torch.int64),
                         p0 + t + gaps[..., t]], 1)
        ks = torch.where(dd >= 0, dd * stride + pos.clamp_max(stride - 1),
                         big).sort(dim=1).values
        if not clamp:
            dup = torch.zeros_like(ks, dtype=torch.bool)
            dup[:, 1:] = ks[:, 1:] == ks[:, :-1]
            ks = ks.masked_fill(dup, big).sort(dim=1).values
        ks = torch.cat([ks, ks.new_full((B, max(0, PW - ks.shape[1])), big)],
                       1)[:, :PW]
        n_live = (ks < big).sum(1)
        keys[at_k[:, t, None] + torch.arange(PW, device=dev)[None, :]] = \
            ks.masked_fill(ks >= big, INT32_MAX).to(torch.int32)
        meta[:, t], meta[:, T + t], meta[:, 2 * T + t] = at_p[:, t], live, 3
        meta[:, 3 * T + t], meta[:, 4 * T + t] = at_k[:, t], n_live
    if repeat:
        meta[:, 1::T] = meta[:, 0::T]
    fmeta[:, :T] = 0.5 + 3.5 * rand_unit(gen, (B, T))
    if repeat:
        fmeta[:, 1] = fmeta[:, 0]
    fmeta[:, T] = 24.0
    return meta, fmeta, doc_ids, freqs, masks, dl, keys


# (label, Ws, PWs, slop, k, layout, stride, distinct queries, batch):
# W0 / PW at the serving buckets 2048..131072, T = 2..4, slop 0/1/3,
# k = 1/16/64; a batch above a distinct count repeats those queries, so
# that it outgrows the kernel's grid (4096 blocks; 512 at W0 = 131072)
PHRASE_CASES = [
    ("t2-exact", (2048, 2048), (4096, 4096), 0, 16, None, 64, 48, 48),
    ("t2-slop2", (2048, 2048), (4096, 4096), 2, 16, None, 64, 48, 48),
    ("t2-bigpos", (2048, 2048), (4096, 131072), 0, 16, None, 64, 48, 48),
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


def phrase_case_args(gen, case):
    label, Ws, PWs, slop, k, layout, stride, n_q, B = case
    n_docs = min(2_000_000, (2**31 - 1) // stride - 1)
    args = make_phrase_windows(gen, n_q, Ws, PWs, stride=stride,
                               n_docs=n_docs, clamp=layout == "clamp",
                               repeat=layout == "repeat")
    if B > n_q:
        pick = rand_ints(gen, 0, n_q, (B,), torch.int64)
        args = (args[0][pick], args[1][pick]) + args[2:]
    return args, dict(T=len(Ws), Ws=Ws, PWs=PWs, stride=stride, slop=slop,
                      k=k)


def phase_phrase_vs_plain(dev) -> float:
    """The phrase kernel against `phrase_plain` on every PHRASE_CASES
    case, top-k and raw: docs and counts equal, scores bit-identical,
    lane for lane.  Returns the max abs score difference (0)."""
    gen = torch.Generator(device=dev).manual_seed(13)
    err = 0.0
    for case in PHRASE_CASES:
        args, kw = phrase_case_args(gen, case)
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


# --------------------------------------------------------------- phase 3b
PROBES_SRC = "redisearch_tpu_torch/csrc/probes.cu"
#: grid_floor's and gstep2's arms also run at B1's batch, where 8,192 /
#: G groups (G up to 16) outnumber the card's 132 SMs
PROBE_B_WIDE = 8192
#: per probe kernel: the TPU functions it replaces, and the script and
#: arm whose times stand in its `kernels` record (probe_floor's and
#: probe_gcols' at B1's batch: at the scripts' B one call is a launch)
PROBE_RECORDS = {
    "probe_floor": ("benchmarks/grid_floor_probe.py:48,76,92,191",
                    f"grid_floor B={PROBE_B_WIDE}", "fused"),
    "probe_gwin": ("benchmarks/gstep_probe.py:32, "
                   "benchmarks/grid_floor_probe.py:111", "gstep",
                   "G=1 staged"),
    "probe_gcols": ("benchmarks/gstep_probe2.py:33",
                    f"gstep2 B={PROBE_B_WIDE}", "G=1"),
    "probe_variant": ("benchmarks/kernel_probe.py:68", "kernel",
                      "Wp= 2048 Wm= 8192 phase"),
}


def probe_groups(dev) -> list:
    """(script, meta, arms) of every arm of the four probe scripts at
    their own B, grid_floor's windows random (seed 1), and grid_floor's
    and gstep2's arms again at B = PROBE_B_WIDE."""
    out = []
    for name, mod_name in PB.SCRIPTS.items():
        mod = importlib.import_module(f"redisearch_tpu_torch.bench.{mod_name}")
        groups = mod.arms(dev, seed=1, B=512) if name == "grid_floor" else \
            mod.arms(dev)
        out += [(name, meta, arms) for meta, arms in groups]
    gf = importlib.import_module("redisearch_tpu_torch.bench.grid_floor_probe")
    out += [(f"grid_floor B={PROBE_B_WIDE}", meta, arms)
            for meta, arms in gf.arms(dev, seed=1, B=PROBE_B_WIDE)]
    g2 = importlib.import_module("redisearch_tpu_torch.bench.gstep_probe2")
    out += [(f"gstep2 B={PROBE_B_WIDE}", meta, arms)
            for meta, arms in g2.arms(dev, B=PROBE_B_WIDE)]
    return out


def probe_edge_groups(dev) -> list:
    """(what, meta, arms), checked and not timed: the cases the scripts'
    inputs miss.  kernel_probe's windows with random freqs (0-7, so
    scores tie) and doc lengths, starts at start % 128 != 0, a third of
    the pivots cut to 0-15 live lanes and a sixth with a qmask no mask
    meets, at k = 1, 16 and 128 (a warp's candidate buffer of 96, 96
    and 288 pairs); gstep's windows with live offsets past the window,
    at its last lane and negative, at unaligned starts.  Odd shapes on
    random arrays of 2,000 rows, starts from before the first row to
    past the last (clamped): probe_variant with three slots of 15, 31
    and 13 rows (no multiple of its 8-row tile) at k = 5, 40 and 128;
    probe_gwin's staged arm with 37-row windows and with 5 + 131-row
    pairs, a few blocks (its widest tiles, short last ones).  The
    persistent kernels at B = 3 (fewer groups than blocks) and 4,613
    (blocks of 2 and 3 groups, curany's of 34 and 35) on random meta:
    probe_floor's cur, curany and fused, probe_gcols with starts from
    before the first row to past the last; and at B = 65,536, G = 4
    (16,384 groups: every block walks several)."""
    rng = np.random.default_rng(5)
    kp = importlib.import_module("redisearch_tpu_torch.bench.kernel_probe")
    gs = importlib.import_module("redisearch_tpu_torch.bench.gstep_probe")
    out = []
    win_rng = np.random.default_rng(0)
    for Wp, Wm in kp.WS:
        meta, fmeta, d2, f2, m2, dl2 = kp.make_windows(win_rng, Wp, Wm)
        B = meta.shape[0]
        q = np.arange(B)
        f2 = rng.integers(0, 8, f2.shape).astype(np.float32)
        dl2 = (np.abs(rng.normal(24.0, 6.0, dl2.shape)) + 1.0).astype(
            np.float32)
        meta = meta.copy()
        meta[:, 0] += (q * 29 % 128).astype(np.int32)
        meta[0::3, 2] = (q[0::3] % 16).astype(np.int32)
        meta[1::6, 4] = 4
        meta, fmeta, d2, f2, m2, dl2 = (torch.from_numpy(x).to(dev) for x in
                                        (meta, fmeta, d2, f2, m2, dl2))
        arrs = (fmeta, d2, f2, m2, dl2)
        arms = [PB.Arm(f"Wp={Wp} Wm={Wm} {mode} k={k} random scores",
                       "probe_variant",
                       lambda m, k=k, mode=mode, Ws=(Wp, Wm), a=arrs:
                       PB.probe_variant(m, *a, Ws=Ws, k=k, mode=mode),
                       lambda m, k=k, mode=mode, Ws=(Wp, Wm), a=arrs:
                       PB.variant_plain(m, *a, Ws=Ws, k=k, mode=mode), 0, B)
                for mode, ks in (("phase", (1, 16, 128)), ("load", (16,)))
                for k in ks]
        out.append((f"kernel edges Wp={Wp} Wm={Wm}", meta, arms))
    meta, d, f = gs.inputs(dev)
    B = meta.shape[0]
    meta = meta.clone()
    meta[:, 0] += torch.arange(B, dtype=torch.int32, device=dev) * 37 % 128
    meta[0::4, 1] = 64 * 128 + 5
    meta[1::4, 1] = 64 * 128 - 1
    meta[2::4, 1] = -3
    arms = [PB.Arm(f"G={G} staged live offsets", "probe_gwin",
                   lambda m, G=G: PB.probe_gwin(m, d, f, rows=(64,), G=G),
                   lambda m, G=G: PB.gwin_plain(m, d, f, rows=(64,), G=G),
                   0, B, tol=2) for G in gs.GS]
    out.append(("gstep edges", meta, arms))
    n_rows = 2000

    def t(x):
        return torch.from_numpy(x).to(dev)

    def gcols_meta(B):
        """gstep2's meta for B queries: starts from before the first row
        to past the last (clamped), weights' bits from [0.5, 2)."""
        return np.stack([
            rng.integers(-300, n_rows * PB.BLK + 300, B).astype(np.int32),
            rng.uniform(0.5, 2.0, B).astype(np.float32).view(np.int32)], 1)

    starts = rng.integers(-300, n_rows * PB.BLK + 300, (64, 3), dtype=np.int32)
    meta = t(np.concatenate([
        starts, rng.integers(0, 1200, (64, 3), dtype=np.int32),
        rng.choice(np.array([1, 2, 3, 4], np.int32), (64, 3))], 1))
    fmeta = t(np.concatenate([rng.uniform(0.5, 4.0, (64, 3)),
                              rng.uniform(10.0, 40.0, (64, 1))],
                             1).astype(np.float32))
    arrs = (fmeta,
            t(rng.integers(0, 10**6, (n_rows, PB.BLK), dtype=np.int32)),
            t(rng.integers(0, 8, (n_rows, PB.BLK)).astype(np.float32)),
            t(rng.choice(np.array([1, 2, 4], np.int32), (n_rows, PB.BLK))),
            t((np.abs(rng.normal(24.0, 6.0, (n_rows, PB.BLK))) + 1.0)
              .astype(np.float32)))
    Ws = (1000, 3000, 640)
    out.append(("variant odd shapes", meta, [
        PB.Arm(f"T=3 Ws={Ws} {mode} k={k}", "probe_variant",
               lambda m, k=k, mode=mode: PB.probe_variant(
                   m, *arrs, Ws=Ws, k=k, mode=mode),
               lambda m, k=k, mode=mode: PB.variant_plain(
                   m, *arrs, Ws=Ws, k=k, mode=mode), 0, 64)
        for mode, ks in (("phase", (5, 40, 128)), ("load", (5,)))
        for k in ks]))
    d = t(rng.integers(-2**30, 2**30, (n_rows, PB.BLK), dtype=np.int32))
    f = t(rng.normal(size=(n_rows, PB.BLK)).astype(np.float32))
    meta = t(np.stack([rng.integers(-300, n_rows * PB.BLK + 300, 24),
                       rng.integers(-5, 37 * PB.BLK + 5, 24)],
                      1).astype(np.int32))
    out.append(("gwin odd shapes, one window", meta, [
        PB.Arm(f"rows=(37,) G={G} staged", "probe_gwin",
               lambda m, G=G: PB.probe_gwin(m, d, f, rows=(37,), G=G),
               lambda m, G=G: PB.gwin_plain(m, d, f, rows=(37,), G=G),
               0, 24, tol=2) for G in (1, 3)]))
    meta = t(rng.integers(-300, n_rows * PB.BLK + 300, (24, 2),
                          dtype=np.int32))
    out.append(("gwin odd shapes, two windows", meta, [
        PB.Arm(f"rows=(5, 131) G={G} staged", "probe_gwin",
               lambda m, G=G: PB.probe_gwin(m, d, f, rows=(5, 131), G=G),
               lambda m, G=G: PB.gwin_plain(m, d, f, rows=(5, 131), G=G),
               0, 24) for G in (1, 2, 4)]))
    d100 = t(rng.integers(0, 100, (n_rows, PB.BLK), dtype=np.int32))
    for B in (3, 4613):
        meta = t(rng.integers(-2**31, 2**31 - 1, (B, 8), dtype=np.int32))
        fm = t(rng.normal(size=(B, 1, 3)).astype(np.float32))
        out.append((f"floor B={B}", meta, [
            PB.Arm(name, "probe_floor",
                   lambda m, kw=kw: PB.probe_floor(m, **kw),
                   lambda m, kw=kw: PB.floor_plain(m, layout=kw["layout"]),
                   0, B)
            for name, kw in (
                ("cur", dict(layout="cur", fmeta=fm)),
                ("curany", dict(layout="cur", fmeta=fm,
                                anys=(d, f, d, f))),
                ("fused", dict(layout="fused")))]))
        gm = gcols_meta(B)
        gm[:2, 0] = (-1, n_rows * PB.BLK)   # before the first row, past the last
        out.append((f"gcols B={B}, starts clamped", t(gm), [
            PB.Arm("G=1", "probe_gcols",
                   lambda m: PB.probe_gcols(m, d100),
                   lambda m: PB.gcols_plain(m, d100), 0, B)]))
    # more groups than resident blocks, G > 1: blocks walk several groups
    meta = t(gcols_meta(65536))
    out.append(("walks of several groups, B=65536", meta, [
        PB.Arm("floor fused G=4", "probe_floor",
               lambda m: PB.probe_floor(m, G=4),
               lambda m: PB.floor_plain(m, G=4), 0, 65536),
        PB.Arm("gcols G=4", "probe_gcols",
               lambda m: PB.probe_gcols(m, d100, G=4),
               lambda m: PB.gcols_plain(m, d100, G=4), 0, 65536)]))
    return out


def log_rings(groups) -> None:
    """The TMA ring each ring arm's launch gets (stages, tile rows,
    shared bytes, resident blocks an SM, registers, spills)."""
    for ring in dict.fromkeys(arm.ring for _n, _m, arms in groups
                              for arm in arms if arm.ring):
        log(f"phase probes: ring of {ring[0]} at {ring[1]} blocks"
            f"{f', k={ring[2]}' if ring[2:] and ring[2] else ''}: "
            f"{PB.ring_info(*ring)}")


def phase_probes(dev, smi: str) -> list:
    """Phase 3b: every probe arm (and the edge cases) against its plain
    version, the launch counts, the rings, then each scripted arm's
    times; returns the probe kernels' records."""
    t0 = time.perf_counter()
    groups = probe_groups(dev)
    edges = probe_edge_groups(dev)
    PB.reset_launches()
    errs = {k: 0.0 for k in PROBE_RECORDS}
    for name, meta, arms in groups + edges:
        for arm in arms:
            bad, err = PB.compare(arm.run(meta), arm.plain(meta), arm.tol)
            if bad:
                raise AssertionError(f"phase probes: {name} {arm.name}: "
                                     f"{bad} queries differ from the plain "
                                     f"version (max |d| {err})")
            if arm.kernel in errs:
                errs[arm.kernel] = max(errs[arm.kernel], err)
    torch.cuda.synchronize()
    counts = PB.launches()
    if min(counts.values()) == 0:
        raise AssertionError(f"phase probes: a probe kernel never "
                             f"launched: {counts}")
    n_arms = sum(len(a) for _n, _m, a in groups)
    n_edge = sum(len(a) for _n, _m, a in edges)
    log(f"phase probes: {n_arms} arms and {n_edge} edge cases == their "
        f"plain versions (gstep within 2, every other lane exact); "
        f"launches {counts}; max |d| {errs}")
    log_rings(groups)
    log(f"phase probes: {smi}")
    times = {}
    for name, meta, arms in groups:
        metas = PB.rolled(meta)
        for arm in arms:
            dev_ms = time_ms(lambda: arm.run(meta))
            wall = PB.wall_s(arm.run, metas)
            times[(name, arm.name)] = (arm, meta, dev_ms)
            log(f"phase probes: {name} {arm.name}: device "
                f"{dev_ms * 1e3 / arm.B:.4f} us/q, wall "
                f"{wall * 1e6 / arm.B:.4f} us/q, bound "
                f"{PB.bound_us(arm.n_bytes) / arm.B:.6f} us/q "
                f"({arm.n_bytes} B a call)")
    recs = []
    for kern, (replaces, script, arm_name) in PROBE_RECORDS.items():
        arm, meta, k_ms = times[(script, arm_name)]
        p_ms = time_ms(lambda: arm.plain(meta))
        lib_ms, lib_d = None, ""
        if arm.library is not None:
            lib = arm.library(meta)
            lib_ms = time_ms(lib)
            ref = arm.plain(meta)
            ref = ref[0] if isinstance(ref, tuple) else ref
            got = lib().reshape(ref.shape).to(torch.float64)
            diff = (got - ref.to(torch.float64)).abs()
            rel = diff / ref.to(torch.float64).abs().clamp_min(1e-30)
            lib_d = (f" (its max |d| from the plain version "
                     f"{float(diff.max()):.6g}, relative "
                     f"{float(rel.max()):.3g})")
        b_ms = bound_ms(arm.n_bytes)
        log(f"phase probes: {kern} ({script} {arm_name}, B={arm.B}): "
            f"kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, bound {b_ms:.6f} "
            f"ms, library "
            f"{'none' if lib_ms is None else f'{lib_ms:.4f} ms'}{lib_d}")
        recs.append({"name": kern, "route": "cuda", "source": PROBES_SRC,
                     "replaces": replaces, "launches": counts[kern],
                     "max_abs_err": errs[kern], "ms": k_ms,
                     "plain_ms": p_ms, "bound_ms": b_ms,
                     "bound_by": "bytes", "library_ms": lib_ms})
    log(f"phase probes: done in {time.perf_counter() - t0:.1f}s")
    return recs


# ---------------------------------------------------------------- phase 4
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


def bound_ms(n_bytes: float) -> float:
    """The least time the card could take to move n_bytes at its memory
    rate.  Every kernel here does a handful of integer or f32 operations
    per byte it reads, far below the 67 TFLOP/s f32 rate, so bytes bound
    them all."""
    return n_bytes / HBM_BYTES_PER_S * 1e3


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
                ix=ix, docs=docs, qt=qt, results=results)


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


# --------------------------------------------------------------- phase 13
#: the wire: connections, queries of each family, timed passes
WIRE_CONNS, WIRE_EACH, WIRE_PASSES = 64, 1024, 3


class _Reply:
    """An FT.SEARCH WITHSCORES reply as a result (`same_hits` reads it)."""

    def __init__(self, reply, content: bool):
        self.total = reply[0]
        step = 3 if content else 2
        self.hits = [rt.Hit(reply[i], float(reply[i + 1]),
                            fields=(dict(zip(reply[i + 2][::2],
                                             reply[i + 2][1::2]))
                                    if content else None))
                     for i in range(1, len(reply), step)]


def wire_value(x):
    """A row value as the RESP client reads it back."""
    if isinstance(x, str):
        return x
    if isinstance(x, (bool, int, np.integer)):
        return int(x)
    if isinstance(x, (float, np.floating)):
        return repr(float(x))
    return str(x)


def agg_argv(req) -> list:
    """FT.AGGREGATE argv of a GROUPBY / SORTBY / LIMIT request."""
    argv = ["FT.AGGREGATE", "bm25", req.query]
    for st in req.steps:
        if isinstance(st, AP.GroupStep):
            argv += ["GROUPBY", len(st.by)] + ["@" + b.lstrip("@")
                                               for b in st.by]
            for fn, args, alias in st.reducers:
                argv += ["REDUCE", fn, len(args), *args, "AS", alias]
        elif isinstance(st, AP.SortStep):
            flat = []
            for prop, asc in st.keys:
                flat += ["@" + prop.lstrip("@"), "ASC" if asc else "DESC"]
            argv += ["SORTBY", len(flat), *flat]
        elif isinstance(st, AP.LimitStep):
            argv += ["LIMIT", st.offset, st.num]
        else:
            raise AssertionError(f"agg_argv: no argv for {st}")
    return argv


def phase_wire(main, dev) -> dict:
    """Phase 13 (see the docstring): the RESP wire on the 1M-doc index."""
    from torch.profiler import ProfilerActivity, profile
    from redisearch_tpu_torch import server as S
    t_phase = time.perf_counter()
    client, ix, qt = main["client"], main["ix"], main["qt"]
    fams = list(FAMILIES)
    # the first WIRE_EACH queries of each family, interleaved
    order = [(fam, i) for i in range(WIRE_EACH) for fam in fams]
    cmds = [("FT.SEARCH", "bm25", FAMILIES[fam](qt, i), "NOCONTENT",
             "WITHSCORES") for fam, i in order]
    srv, port, stop = start_server(client)
    # the engine's share of a pass: seconds inside the client's search
    # calls (the micro-batches' ft_search_many, groups of one ft_search)
    engine = {"ft_search_many": [0.0, 0], "ft_search": [0.0, 0]}

    def timed(name):
        real = getattr(client, name)

        def call(*a, **k):
            t0 = time.perf_counter()
            try:
                return real(*a, **k)
            finally:
                engine[name][0] += time.perf_counter() - t0
                engine[name][1] += 1
        return call

    try:
        zero_counts()
        passes, hists = [], []
        client.ft_search_many = timed("ft_search_many")
        client.ft_search = timed("ft_search")
        try:
            for _ in range(WIRE_PASSES):
                srv.batch_sizes.clear()
                replies, dt = wire_run(port, cmds, WIRE_CONNS)
                passes.append(dt)
                hists.append(dict(sorted(srv.batch_sizes.items())))
        finally:
            del client.ft_search_many, client.ft_search
        torch.cuda.synchronize(dev)
        b1, b2 = IK.LAUNCHES, IK.PHRASE_LAUNCHES
        n_exact = 0
        for (fam, i), rep in zip(order, replies):
            want = main["results"][fam][i]
            got = _Reply(rep, content=False)
            same_hits(got, want, f"wire {fam} {i}")
            n_exact += ([(h.key, h.score) for h in got.hits]
                        == [(h.key, h.score) for h in want.hits])
        qps = [len(cmds) / dt for dt in passes]
        log(f"phase wire: {len(cmds)} FT.SEARCH NOCONTENT WITHSCORES over "
            f"{WIRE_CONNS} connections ({WIRE_EACH} of each of the "
            f"{len(fams)} families, interleaved), RESP parser "
            f"{srv.parser}: every reply == ft_search_many's result "
            f"(phase 4; {n_exact} bit for bit, the rest within 1e-5 at "
            f"ties); wire qps {sorted(qps)[1]:.1f} (median of "
            f"{WIRE_PASSES} passes: {', '.join(f'{q:.1f}' for q in qps)}; "
            f"host clock); phase 4's ft_search_many at batch {BATCH} is "
            f"the batched reference")
        log(f"phase wire: micro-batch sizes (size: groups) of the last "
            f"pass {hists[-1]}")
        busy_s = sum(v[0] for v in engine.values())
        log(f"phase wire: engine calls over the {WIRE_PASSES} passes: "
            f"ft_search_many {engine['ft_search_many'][1]} calls "
            f"{engine['ft_search_many'][0]:.3f} s, ft_search (groups of "
            f"one) {engine['ft_search'][1]} calls "
            f"{engine['ft_search'][0]:.3f} s: {100.0 * busy_s / sum(passes):.1f}"
            f"% of the passes' {sum(passes):.3f} s")
        if srv.parser != "native":
            raise AssertionError("wire: the native RESP codec did not "
                                 "build; the Python parser served")
        # 64 with content: fields as the doc table holds them
        with_content = [("FT.SEARCH", "bm25", FAMILIES[fams[i % 8]](qt, i),
                         "WITHSCORES") for i in range(64)]
        creps, _dt = wire_run(port, with_content, WIRE_CONNS)
        for i, rep in enumerate(creps):
            want = main["results"][fams[i % 8]][i]
            got = _Reply(rep, content=True)
            same_hits(got, want, f"wire content {i}")
            for hg, hw in zip(got.hits, want.hits):
                if hg.key == hw.key and hg.fields != {
                        f: S._tostr(v) for f, v in hw.fields.items()}:
                    raise AssertionError(f"wire content {i} {hg.key}: "
                                         f"{hg.fields} != {hw.fields}")
        # 64 FT.AGGREGATE: phase 6's request and the '*' COUNT
        mk, _mk_sd, _mk_mm = agg_request_fn()
        reqs = [mk(i) for i in range(32)] + [
            rt.AggregateRequest("*").group_by("@grp", ("COUNT", [], "n"))
            .sort_by(("@n", rt.DESC), "@grp") for _ in range(32)]
        aggs = [agg_argv(r) for r in reqs]
        areps, adt = wire_run(port, aggs, WIRE_CONNS)
        for argv, rep in zip(aggs, areps):
            req = srv._parse_agg_request(S.Argv([str(a) for a in argv[2:]]))
            res = client.ft_aggregate("bm25", req)
            want = [len(res.rows)] + [[wire_value(x)
                                       for x in S._row_flatten(r)]
                                      for r in res.rows]
            if rep != want:
                raise AssertionError(f"wire {argv[:4]}: {rep[:3]} != "
                                     f"{want[:3]}")
        star_total = sum(int(float(row[3])) for row in areps[32][1:])
        if star_total != len(main["docs"]):
            raise AssertionError(f"wire '*' COUNT sums to {star_total}")
        torch.cuda.synchronize(dev)
        b34 = GB.LAUNCHES + GB.SINGLE_LAUNCHES
        log(f"phase wire: 64 FT.SEARCH with content == ft_search_many's "
            f"hits and fields; 64 FT.AGGREGATE (32 of phase 6's request, "
            f"32 '*' GROUPBY @grp COUNT summing to {star_total}) == "
            f"Client.ft_aggregate, in {adt:.3f}s")
        log(f"phase wire: launches during the phase: B1 {b1}, B2 {b2} "
            f"(the {WIRE_PASSES} search passes), B3/B4 {b34} (batched "
            f"{GB.LAUNCHES}, fused single-query {GB.SINGLE_LAUNCHES})")
        if b1 <= 0 or b2 <= 0 or b34 <= 0:
            raise AssertionError("wire: a kernel was not reached over "
                                 "the wire")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _r, traced = wire_run(port, cmds, WIRE_CONNS)
            torch.cuda.synchronize(dev)
        busy, kerns = device_busy_us(prof)
        log(f"phase wire: traced pass {traced * 1e3:.3f} ms, device busy "
            f"{busy:.1f} us (B1 {kerns['intersect_kernel']:.1f} us, B2 "
            f"{kerns['phrase_kernel']:.1f} us), idle share "
            f"{1.0 - busy / (traced * 1e6):.4f}")
        # where a wire pass's host time goes: RESP parse and format
        parse_s, fmt_s = wire_codec_seconds(
            srv, cmds, [main["results"][fam][i] for fam, i in order])
        log(f"phase wire: RESP parse of the {len(cmds)} commands "
            f"{parse_s * 1e3:.3f} ms, reply format + encode "
            f"{fmt_s * 1e3:.3f} ms, of a {sorted(passes)[1] * 1e3:.3f} ms "
            f"median pass ({100.0 * (parse_s + fmt_s) / sorted(passes)[1]:.2f}"
            f"%)")
    finally:
        stop()
    log(f"phase wire: done in {time.perf_counter() - t_phase:.1f}s")
    return {"qps": sorted(qps)[1], "b1": b1, "b2": b2, "b34": b34}


def wire_codec_seconds(srv, cmds, results) -> tuple:
    """Host seconds of the RESP layer alone for one pass: the native
    parser over the pass's command bytes, and `_parse_search`,
    `_format_search` and `encode` over the pass's results."""
    from redisearch_tpu_torch import native_resp, server as S
    blob = b"".join(
        b"*%d\r\n" % len(c) + b"".join(
            b"$%d\r\n%s\r\n" % (len(str(a).encode()), str(a).encode())
            for a in c) for c in cmds)
    p = native_resp.RespParser()
    t0 = time.perf_counter()
    p.feed(blob)
    n = 0
    while p.next() is not None:
        n += 1
    parse_s = time.perf_counter() - t0
    if n != len(cmds):
        raise AssertionError(f"native parser: {n} of {len(cmds)} commands")
    t0 = time.perf_counter()
    for c, res in zip(cmds, results):
        spec = srv._parse_search(S.Argv(list(c[1:])))
        S.encode(srv._format_search(res, spec), 2)
    return parse_s, time.perf_counter() - t0


# --------------------------------------------------------------- phase 14
def numpy_leaf_sets(seg, ix, q: str) -> list:
    """Matching local doc ids of each leaf of `q` from the host-copied
    postings: each token group (the token and its expansions, field mask
    tested) as a sorted set."""
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
    return sets


def edits1(word: str, alphabet: str) -> set:
    """Every string within one edit of `word` over `alphabet`."""
    out = set()
    for i in range(len(word) + 1):
        left, right = word[:i], word[i:]
        if right:
            out.add(left + right[1:])
            out.update(left + c + right[1:] for c in alphabet)
        if len(right) > 1:
            out.add(left + right[1] + right[0] + right[2:])
        out.update(left + c + right for c in alphabet)
    return out


def phase_surface(main, dev) -> None:
    """Phase 14 (see the docstring): the command surface on the card."""
    from redisearch_tpu_torch import ext, server as S
    from redisearch_tpu_torch.aux.highlight import (
        HighlightOptions, SummarizeOptions, highlight_field,
        summarize_field)
    from redisearch_tpu_torch.utils import errors as ERR
    t_phase = time.perf_counter()
    client, ix, qt = main["client"], main["ix"], main["qt"]
    seg = ix.segments[0]
    n_docs = len(main["docs"])
    info = client.ft_info("bm25")
    mem = sum(s.memory_bytes() for s in ix.segments)
    nnz = sum(s.text.nnz for s in ix.segments)
    if (info["num_docs"] != n_docs or info["num_records"] != nnz
            or info["inverted_sz_mb"] != mem / 1e6):
        raise AssertionError(f"FT.INFO: {info['num_docs']} docs, "
                             f"{info['num_records']} records, "
                             f"{info['inverted_sz_mb']} MB")
    log(f"phase surface: FT.INFO num_docs {info['num_docs']}, num_records "
        f"{info['num_records']} (the segments' nnz), inverted_sz_mb "
        f"{info['inverted_sz_mb']:.3f} (memory_bytes), num_terms "
        f"{info['num_terms']}")

    # FT.PROFILE SEARCH, one query a family
    for fam, fn in FAMILIES.items():
        q = fn(qt, 0)
        res, prof = client.ft_profile("bm25", "SEARCH", q)
        same_hits(res, client.ft_search("bm25", q), f"profile {fam}")
        it = prof["iterators"]
        if it["counter"] != res.total:
            raise AssertionError(f"profile {fam}: root counter "
                                 f"{it['counter']} != total {res.total}")
        if fam == "and2":
            sets = numpy_leaf_sets(seg, ix, q)
            kids = [c["counter"] for c in it.get("children", [])]
            if (it["counter"] != numpy_and2_count(seg, ix, q)
                    or kids != [len(s) for s in sets]):
                raise AssertionError(f"profile and2: counters {it} vs "
                                     f"numpy {[len(s) for s in sets]}")
        if not (prof["execution_time_ms"] > 0
                and prof["warm_execution_time_ms"] > 0):
            raise AssertionError(f"profile {fam}: clocks {prof}")
        log(f"phase surface: FT.PROFILE {fam} {q!r}: total {res.total}, "
            f"root counter {it['counter']}, children "
            f"{[c['counter'] for c in it.get('children', [])]}; execution "
            f"{prof['execution_time_ms']:.3f} ms, warm "
            f"{prof['warm_execution_time_ms']:.3f} ms, root node "
            f"{it['time_ms']:.3f} ms (after a synchronize)")

    # EXPLAINSCORE of the top hit of 64 queries
    n_ex, worst = 0, 0.0
    for i in range(512):
        q = FAMILIES["and2"](qt, i // 2) if i % 2 else qt[i // 2]
        r = client.ft_search("bm25", q, num=1)
        if not r.hits:
            continue
        ex = client.ft_explainscore("bm25", q, r.hits[0].key)
        rel = abs(ex["value"] - r.hits[0].score) / abs(r.hits[0].score)
        worst = max(worst, rel)
        if rel > 1e-5:
            raise AssertionError(f"EXPLAINSCORE {q!r}: {ex['value']} vs "
                                 f"{r.hits[0].score}")
        n_ex += 1
        if n_ex == 64:
            break
    if n_ex < 64:
        raise AssertionError(f"EXPLAINSCORE: {n_ex} queries with hits")
    log(f"phase surface: FT.EXPLAINSCORE of 64 top hits (and2 and "
        f"single-term queries) == "
        f"the served score, max relative difference {worst:.3e}")

    # HIGHLIGHT and SUMMARIZE on 64 hits
    n_hl = 0
    so = SummarizeOptions(frag_len=8, num_frags=2, separator="... ")
    for i in range(256):
        if n_hl == 64:
            break
        q = FAMILIES["or2"](qt, i)
        hl = client.ft_search("bm25", q, num=min(8, 64 - n_hl),
                              highlight={"fields": ["title", "body"]})
        sm = client.ft_search("bm25", q, num=min(8, 64 - n_hl),
                              summarize={"fields": ["body"], "frag_len": 8,
                                         "num_frags": 2})
        for hh, hs in zip(hl.hits, sm.hits):
            meta = ix.doctable.get_by_key(hh.key)
            for f in ("title", "body"):
                if hh.fields[f] != highlight_field(
                        ix, meta.fields[f], hl.query_ast, HighlightOptions()):
                    raise AssertionError(f"HIGHLIGHT {q!r} {hh.key} {f}")
            if "<b>" not in hh.fields["title"] + hh.fields["body"]:
                raise AssertionError(f"HIGHLIGHT {q!r} {hh.key}: no tag")
            if hs.fields["body"] != summarize_field(
                    ix, meta.fields["body"], sm.query_ast, so):
                raise AssertionError(f"SUMMARIZE {q!r} {hs.key}")
            n_hl += 1
    if n_hl != 64:
        raise AssertionError(f"HIGHLIGHT/SUMMARIZE: {n_hl} hits")
    log("phase surface: HIGHLIGHT (title, body) and SUMMARIZE (body, LEN 8, "
        "FRAGS 2) on 64 hits of or2 queries == highlight_field / "
        "summarize_field of the same docs")

    # FT.SPELLCHECK: 64 vocabulary words with the last digit made a letter
    terms = seg.terms
    alphabet = "0123456789wx"
    t0 = time.perf_counter()
    words = [w[:-1] + "x" for w in qt[:64]]
    out = client.ft_spellcheck("bm25", " ".join(words))
    sc_s = time.perf_counter() - t0
    if [o["term"] for o in out] != words:
        raise AssertionError(f"SPELLCHECK terms {[o['term'] for o in out]}")
    n_sug = 0
    for o in out:
        cands = [t for t in edits1(o["term"], alphabet) if t in terms.ids]
        want = sorted(((int(terms.doc_freq[terms.ids[t]]) / n_docs, t)
                       for t in cands), key=lambda st: (-st[0], st[1]))[:10]
        if o["suggestions"] != want:
            raise AssertionError(f"SPELLCHECK {o['term']}: "
                                 f"{o['suggestions']} != {want}")
        n_sug += len(want)
    log(f"phase surface: FT.SPELLCHECK of 64 misspelt words == the "
        f"vocabulary's distance-1 terms ranked by doc frequency ({n_sug} "
        f"suggestions) in {sc_s * 1e3:.1f} ms")

    # FT.SUGADD of 100,000 suggestions, FT.SUGGET prefixes
    rng = np.random.default_rng(17)
    sug_scores = rng.integers(1, 1000, 100_000)
    t0 = time.perf_counter()
    for j in range(100_000):
        client.ft_sugadd("sug", "w%06d" % j, float(sug_scores[j]))
    add_s = time.perf_counter() - t0
    prefixes = ["w%05d" % j for j in rng.integers(0, 10_000, 1000)]
    t0 = time.perf_counter()
    got = [client.ft_sugget("sug", p_, with_scores=True) for p_ in prefixes]
    get_s = time.perf_counter() - t0
    for p_, g in zip(prefixes[:16], got[:16]):
        base = int(p_[1:]) * 10
        cand = [("w%06d" % j, float(sug_scores[j]) / np.sqrt(2.0))
                for j in range(base, base + 10)]
        want = sorted(cand, key=lambda c: (-c[1], c[0]))[:5]
        if [(t, s_) for t, s_ in g] != want:
            raise AssertionError(f"SUGGET {p_}: {g} != {want}")
    if client.ft_suglen("sug") != 100_000:
        raise AssertionError("SUGLEN")
    log(f"phase surface: FT.SUGADD of 100,000 suggestions in {add_s:.3f} s "
        f"({100_000 / add_s:.0f} a second); 1,000 FT.SUGGET prefix queries "
        f"in {get_s:.3f} s ({1000 / get_s:.0f} a second), 16 == a brute "
        f"force over the entries")

    # FT.TAGVALS
    tv = client.ft_tagvals("bm25", "cat")
    if tv != ["cat%02d" % i for i in range(16)]:
        raise AssertionError(f"TAGVALS {tv}")
    log(f"phase surface: FT.TAGVALS cat: {len(tv)} values")

    # FT.CONFIG SET TIMEOUT / ON_TIMEOUT with FT.DEBUG's TIMEOUT_AFTER_N
    srv = S.Server(client=client)
    q = FAMILIES["or2"](qt, 0)
    srv.dispatch(["FT.CONFIG", "SET", "TIMEOUT", "10000"])
    srv.dispatch(["FT.CONFIG", "SET", "ON_TIMEOUT", "return"])
    rep = srv.dispatch(["FT.DEBUG", "FT.SEARCH", "bm25", q, "NOCONTENT",
                        "LIMIT", "0", "100", "DEBUG_PARAMS_COUNT", "2",
                        "TIMEOUT_AFTER_N", "5"])
    full = client.ft_search("bm25", q, num=100, no_content=True)
    if (len(rep.r2) != 6 or rep.r3["warning"] != [
            "Timeout limit was reached"]
            or rep.r2[1:] != [h.key for h in full.hits[:5]]):
        raise AssertionError(f"FT.DEBUG TIMEOUT_AFTER_N: {rep.r2}")
    srv.dispatch(["FT.CONFIG", "SET", "ON_TIMEOUT", "fail"])
    rep = srv.dispatch(["FT.DEBUG", "FT.SEARCH", "bm25", q, "LIMIT", "0",
                        "100", "DEBUG_PARAMS_COUNT", "2",
                        "TIMEOUT_AFTER_N", "5"])
    if not isinstance(rep, ERR.TimeoutError_):
        raise AssertionError(f"ON_TIMEOUT fail: {rep!r}")
    cfg = srv.dispatch(["FT.CONFIG", "GET", "TIMEOUT"]).r2
    srv.dispatch(["FT.CONFIG", "SET", "TIMEOUT", "500"])
    srv.dispatch(["FT.CONFIG", "SET", "ON_TIMEOUT", "return"])
    if cfg != [["TIMEOUT", "10000"]] or full.warnings:
        raise AssertionError(f"FT.CONFIG GET TIMEOUT {cfg}")
    log("phase surface: FT.CONFIG SET TIMEOUT 10000 / ON_TIMEOUT return: "
        "FT.DEBUG FT.SEARCH ... TIMEOUT_AFTER_N 5 -> the first 5 of 100 "
        "hits and the timeout warning; ON_TIMEOUT fail -> TimeoutError_")

    # ON_OOM on the card: the device memory read through a patched
    # torch.cuda.mem_get_info (95% in use)
    real = torch.cuda.mem_get_info
    free, total = real(dev)
    torch.cuda.mem_get_info = lambda *a: (total // 20, total)
    try:
        client.ft_config_set("ON_OOM", "return")
        r = client.ft_search("bm25", q)
        rb = client.ft_search_many("bm25", [q], k=K)[0]
        client.ft_config_set("ON_OOM", "fail")
        try:
            client.ft_search("bm25", q)
            raise AssertionError("ON_OOM fail did not raise")
        except ERR.IndexError_:
            pass
    finally:
        torch.cuda.mem_get_info = real
        client.ft_config_set("ON_OOM", "ignore")
    if (r.total or r.hits or not any("OOM" in w for w in r.warnings)
            or rb.total or not any("OOM" in w for w in rb.warnings)):
        raise AssertionError(f"ON_OOM return: {r.total} {r.warnings}")
    if client.ft_search("bm25", q).total != full.total:
        raise AssertionError("ON_OOM ignore after the patch")
    log(f"phase surface: ON_OOM on {dev} (card memory {free}/{total} free, "
        f"read as 5% free): return -> an empty result with the OOM warning "
        f"(ft_search and ft_search_many), fail -> IndexError_")

    # HAMMING and a registered custom scorer, card against CPU
    rng = np.random.default_rng(13)
    pay = rng.integers(0, 256, size=(10_000, 8), dtype=np.uint8)
    vocab = ["alpha", "beta", "gamma", "delta", "omega", "sigma", "kappa",
             "theta"]
    texts = [" ".join(rng.choice(vocab, size=5)) for _ in range(10_000)]
    qp = rng.integers(0, 256, size=(16, 8), dtype=np.uint8)
    ext.register_scorer("CARD_SMOKE", lambda key, fields, base: base * (
        1.0 + int(key[1:]) % 5))
    outs = {}
    try:
        for d in (dev, "cpu"):
            c = rt.Client(device=d)
            c.ft_create("ham", [rt.Field("t", rt.FieldType.TEXT)])
            for j in range(10_000):
                c.ft_add("ham", f"h{j}", 1.0, {"t": texts[j]},
                         payload=pay[j].tobytes())
            outs[str(d)] = (
                [c.ft_search("ham", vocab[j % 8], scorer="HAMMING",
                             payload=qp[j].tobytes(), num=10,
                             no_content=True) for j in range(16)],
                [c.ft_search("ham", f"{vocab[j % 8]} {vocab[(j + 3) % 8]}",
                             scorer="CARD_SMOKE", num=10, no_content=True)
                 for j in range(16)])
    finally:
        ext._SCORERS.pop("CARD_SMOKE", None)
    (hc, cc), (hh, ch) = outs[str(dev)], outs["cpu"]
    for j, (a, b) in enumerate(zip(hc, hh)):
        if (a.total != b.total or [(h.key, h.score) for h in a.hits]
                != [(h.key, h.score) for h in b.hits] or not a.hits):
            raise AssertionError(f"HAMMING {j}: card != cpu")
    for j, (a, b) in enumerate(zip(cc, ch)):
        same_hits(a, b, f"custom scorer {j}")
    log("phase surface: HAMMING (8-byte payloads) and a registered custom "
        "scorer on a 10,000-doc index, 16 queries each: the card's ids and "
        "scores == the same build on the CPU")
    log(f"phase surface: done in {time.perf_counter() - t_phase:.1f}s")


# ---------------------------------------------------------------- phase 7
#: bench.py's knn section: 1M x 128 f32 rows, L2, k = 10, batches of 2048
KNN_N, KNN_D, KNN_K, KNN_B = 1_000_000, 128, 10, 2048
#: query chunks scanned (bench.py scans 48; 4 hold the checks and times)
KNN_CHUNKS = 4
#: the filtered-KNN section's batch here (bench.py's is 512)
FKNN_B = 2048
#: batches of the pipelined QPS loop (the hoisted and knn-row families
#: take about 5 s a batch on the host)
FKNN_PIPE = 2
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
    ix = client.ft_create("arxivb", fknn_fields(FKNN_D))
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


def phase_rescore_clustered(dev) -> float:
    """tests/test_units.py::test_two_phase_knn_clustered's input on the
    card: 4,096 x 64 f32 rows and 16 queries at center + 1e-3 * normal
    (numpy seed 11), k 10, where L2's sq - 2 dot + qsq cancels.  Every
    distance `knn_batch` and `knn` return must be within 3e-5 of the
    float64 distance of its row, computed on the card (the f32
    rescore's dot products are taken in float64)."""
    rng = np.random.default_rng(11)
    n, d, k, bq = 4096, 64, 10, 16
    center = rng.normal(size=(d,)).astype(np.float32)
    vecs = (center[None, :]
            + 1e-3 * rng.normal(size=(n, d))).astype(np.float32)
    Q = (center[None, :]
         + 1e-3 * rng.normal(size=(bq, d))).astype(np.float32)
    sq = np.sum(vecs.astype(np.float64) ** 2, 1).astype(np.float32)
    tv, tsq, tq = (torch.from_numpy(a).to(dev) for a in (vecs, sq, Q))
    present = torch.ones(n, dtype=torch.bool, device=dev)
    bd, bi = V.knn_batch(tv, tsq, present, tq, k, "L2")
    singles = [V.knn(tv, tsq, present, tq[b], k, "L2") for b in range(bq)]
    sd = torch.stack([s_[0] for s_ in singles])
    si = torch.stack([s_[1] for s_ in singles])
    errs = []
    for dists, idx in ((bd, bi), (sd, si)):
        g64 = ((tv[idx.long()].double() - tq[:, None, :].double()) ** 2
               ).sum(-1)
        errs.append(float((dists.double() - g64).abs().max()))
    log(f"phase vector: clustered rescore (4,096 x 64, 16 queries, k 10) "
        f"on {torch.cuda.get_device_name(dev)}: max |dist - float64| "
        f"batched {errs[0]:.3e}, single {errs[1]:.3e} (limit 3e-5)")
    if max(errs) > 3e-5:
        raise AssertionError(f"clustered rescore: max error {max(errs)} "
                             f"> 3e-5")
    return max(errs)


def phase_vector(dev) -> dict:
    t0 = time.perf_counter()
    phase_rescore_clustered(dev)
    ops = phase_knn_ops(dev)
    fk = phase_fknn(dev)
    log(f"phase vector: done in {time.perf_counter() - t0:.1f}s")
    return {"ops": ops, **fk}


# --------------------------------------------------------------- phase 7b
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



# -------------------------------------------------------------- phase 15
#: phase 15's queries a family, KNN queries and hybrid queries
DIST_Q, DIST_KNN, DIST_HYB = 32, 64, 32
DIST_SHARDS = 4
#: the sharded k-means step: rows x dims, centroids
KM_N, KM_D, KM_C = 1_000_000, 100, 1024


def view_merge(sh, q: str, num: int = K):
    """The reference for a sharded BM25 search: each shard's own
    `SearchIndex` view searched alone, the hits merged on the host by
    (-score, gid), the totals summed."""
    hits, total = [], 0
    for seg in sh.shards:
        r = D._shard_index_view(sh, seg).search(q, num=num)
        total += r.total
        hits.extend(r.hits)
    hits.sort(key=lambda h: (-h.score, h.gid))
    return total, hits[:num]


def same_exact(a_total, a_hits, b, what, rtol=SCORE_RTOL, field="score"):
    """Totals, keys and their order equal; the `field` of each hit within
    `rtol` (0: equal)."""
    if a_total != b.total or [h.key for h in a_hits] != \
            [h.key for h in b.hits]:
        raise AssertionError(f"{what}: {a_total} "
                             f"{[h.key for h in a_hits]} vs {b.total} "
                             f"{[h.key for h in b.hits]}")
    x = np.array([getattr(h, field) for h in a_hits], np.float64)
    y = np.array([getattr(h, field) for h in b.hits], np.float64)
    np.testing.assert_allclose(y, x, rtol=rtol, atol=0, err_msg=what)


def timed(fn, dev) -> float:
    """Seconds of `fn()` by the host clock, ended by a synchronize."""
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize(dev)
    return time.perf_counter() - t0


def program_merge_ms(sh, ix, qs, dev) -> tuple:
    """Mean ms a query of the shards' window programs (all shards,
    launched and synchronized) and of the coordinator's gather + merge."""
    prog = merge = 0.0
    for q in qs:
        cq = ix.compile(ix.parse_query(q), E.QueryOptions(k=K))
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        outs, kl = sh._shard_outputs(cq, K)
        torch.cuda.synchronize(dev)
        t1 = time.perf_counter()
        sh._merged(cq, sh._gather(cq, outs), kl)
        torch.cuda.synchronize(dev)
        prog += t1 - t0
        merge += time.perf_counter() - t1
    return prog * 1e3 / len(qs), merge * 1e3 / len(qs)


def dist_build(ix, mesh, dev, what) -> tuple:
    """A ShardedIndex of `ix` over `mesh`, its seconds, and a line of
    docs and device MiB per shard."""
    t0 = time.perf_counter()
    sh = D.ShardedIndex.build(ix, mesh)
    torch.cuda.synchronize(dev)
    sec = time.perf_counter() - t0
    per = ", ".join(f"{s.n_docs} docs {s.memory_bytes() / 2**20:.1f} MiB "
                    f"on {s.device}" for s in sh.shards)
    log(f"phase dist: {what}: built over mesh {mesh.shape} in {sec:.2f}s: "
        f"{per}")
    return sh, sec


def phase_dist_search(main, dev, smi) -> dict:
    """Phase 15(a)/(b): the 1M-doc index over 4 and 2 x 2 slots of the
    one card; DIST_Q queries of each family against the views' host
    merge, the 2D mesh, search_many and (DISMAX, numeric SORTBY) the
    single index; QPS, program and merge ms, a traced batch's idle
    share."""
    from torch.profiler import ProfilerActivity, profile
    client, ix, qt = main["client"], main["ix"], main["qt"]
    sh1, b1 = dist_build(ix, D.make_mesh(DIST_SHARDS), dev, "1M docs")
    sh2, b2 = dist_build(ix, D.make_mesh(DIST_SHARDS, n_dcn=2), dev,
                         "1M docs, 2D")
    if sum(s.n_docs for s in sh1.shards) != ix.segments[0].n_docs:
        raise AssertionError("the shards do not hold every doc")
    fams = {f: [fn(qt, i) for i in range(DIST_Q)]
            for f, fn in FAMILIES.items()}
    out = {"build_s": b1, "build_2d_s": b2, "families": {}}
    for fam, qs in fams.items():
        res = [sh1.search(q, num=K) for q in qs]
        for q, r in zip(qs, res):
            same_exact(*view_merge(sh1, q), r, f"dist {fam} {q!r}")
            r2 = sh2.search(q, num=K)
            same_exact(r.total, r.hits, r2, f"2D mesh {fam} {q!r}", rtol=0)
        calls = [0]
        orig = sh1.search

        def counting(*a, **kw):
            calls[0] += 1
            return orig(*a, **kw)
        sh1.search = counting
        many = sh1.search_many(qs, k=K)
        del sh1.search
        for q, r, m in zip(qs, res, many):
            same_exact(r.total, r.hits, m, f"search_many {fam} {q!r}")
        s_search = timed(lambda: [sh1.search(q, num=K) for q in qs], dev)
        s_many = timed(lambda: sh1.search_many(qs, k=K), dev)
        s_win = timed(lambda: [ix.search(q, num=K) for q in qs], dev)
        s_kern = timed(lambda: client.ft_search_many("bm25", qs, k=K), dev)
        prog_ms, merge_ms = program_merge_ms(sh1, ix, qs[:8], dev)
        f = {"search_qps": DIST_Q / s_search, "search_many_qps":
             DIST_Q / s_many, "single_window_qps": DIST_Q / s_win,
             "single_ft_search_many_qps": DIST_Q / s_kern,
             "program_ms": prog_ms, "merge_ms": merge_ms,
             "search_many_fallback": calls[0]}
        idle = ""
        if fam == "and2":
            # one traced batch (reading a trace takes seconds)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                traced = timed(lambda: sh1.search_many(qs, k=K), dev)
            busy, _k = device_busy_us(prof, ())
            f["idle_share"] = 1.0 - busy / (traced * 1e6)
            idle = f"; traced search_many idle share {f['idle_share']:.4f}"
        out["families"][fam] = f
        log(f"phase dist: {fam}: {DIST_Q} searches == the shards' views "
            f"merged by (-score, gid) (totals, ids, order; scores rtol "
            f"{SCORE_RTOL}), == the 2D mesh, search_many == search "
            f"({'per query' if calls[0] else 'one execute_batch'}); qps "
            f"search {f['search_qps']:.1f}, search_many "
            f"{f['search_many_qps']:.1f}, single index window program "
            f"{f['single_window_qps']:.1f}, single ft_search_many (batch "
            f"{DIST_Q}) {f['single_ft_search_many_qps']:.1f}; a query's 4 "
            f"shard programs {prog_ms:.3f} ms "
            f"({prog_ms / DIST_SHARDS:.3f} ms a shard), merge "
            f"{merge_ms:.3f} ms{idle} [{smi}]")
    # shard-invariant scorers against the single index
    for q in fams["and2"] + fams["or2"]:
        a = ix.search(q, num=K, scorer="DISMAX")
        same_exact(a.total, a.hits, sh1.search(q, num=K, scorer="DISMAX"),
                   f"DISMAX {q!r}")
    for i, q in enumerate(fams["or2"] + fams["and2_tag"]):
        asc = bool(i % 2)
        a = ix.search(q, num=K, sort_by="price", sort_asc=asc)
        b = sh1.search(q, num=K, sort_by="price", sort_asc=asc)
        same_exact(a.total, a.hits, b, f"SORTBY price {q!r}", rtol=0,
                   field="sortkey")
    log(f"phase dist: {2 * DIST_Q} DISMAX and {2 * DIST_Q} SORTBY @price "
        "queries == the single index (totals, ids, order; DISMAX scores "
        f"rtol {SCORE_RTOL}, sort keys equal)")
    out["shards"] = sh1
    return out


def same_fused(a, b, what):
    """Fused rows of the sharded and the single index: keys and order
    equal, scores within 1e-6, vector distances within 1e-5 (the single
    index's KNN branch rides the batch executors, the shards' the window
    program)."""
    if [r["__key"] for r in a] != [r["__key"] for r in b]:
        raise AssertionError(f"{what}: keys {[r['__key'] for r in a]} vs "
                             f"{[r['__key'] for r in b]}")
    for ra, rb in zip(a, b):
        if abs(ra["__score"] - rb["__score"]) > 1e-6 or abs(
                ra.get("__vector_distance", 0.0)
                - rb.get("__vector_distance", 0.0)) > 1e-5:
            raise AssertionError(f"{what}: {ra} vs {rb}")


def phase_dist_vector(vctx, dev, smi) -> dict:
    """Phase 15(c): the 500k x 384 COSINE index over 4 slots; KNN 10
    queries and RRF hybrids with DISMAX against the single index."""
    from dataclasses import replace
    from redisearch_tpu_torch.aux.hybrid import run_hybrid
    _client, vix, _v64, qvecs = vctx
    shv, bsec = dist_build(vix, D.make_mesh(DIST_SHARDS), dev,
                           "500k x 384")
    q = "*=>[KNN 10 @emb $b]"
    prm = [{"b": qvecs[i]} for i in range(DIST_KNN)]
    t0 = time.perf_counter()
    dres = [shv.search(q, params=p) for p in prm]
    torch.cuda.synchronize(dev)
    knn_s = time.perf_counter() - t0
    worst = 0.0
    for i, (p, d) in enumerate(zip(prm, dres)):
        s = vix.search(q, params=p)
        if [h.key for h in d.hits] != [h.key for h in s.hits] or \
                d.total != s.total or len(d.hits) != K:
            raise AssertionError(f"KNN {i}: {[h.key for h in d.hits]} vs "
                                 f"{[h.key for h in s.hits]}")
        err = max(abs(a.vector_distance - b.vector_distance)
                  for a, b in zip(d.hits, s.hits))
        if err > 1e-5:
            raise AssertionError(f"KNN {i}: distance error {err}")
        worst = max(worst, err)
    many = shv.search_many([q] * DIST_KNN, params=prm, k=K)
    for i, (m, d) in enumerate(zip(many, dres)):
        same_exact(d.total, d.hits, m, f"KNN search_many {i}",
                   field="vector_distance")
    hqs = [replace(h, search_scorer="DISMAX")
           for h in hybrid_queries(0, "RRF")[:DIST_HYB]]
    t0 = time.perf_counter()
    hd = [run_hybrid(shv, h) for h in hqs]
    hyb_s = time.perf_counter() - t0
    for i, (h, a) in enumerate(zip(hqs, hd)):
        same_fused(a, run_hybrid(vix, h), f"hybrid {i}")
    log(f"phase dist: {DIST_KNN} KNN 10 queries == the single index (ids; "
        f"distances within {worst:.2e} <= 1e-5), search_many == search; "
        f"{DIST_HYB} RRF hybrids (DISMAX text branch) == the single "
        f"index's; qps KNN search {DIST_KNN / knn_s:.1f}, hybrid "
        f"{DIST_HYB / hyb_s:.1f} [{smi}]")
    del shv
    return {"build_s": bsec, "knn_qps": DIST_KNN / knn_s,
            "hybrid_qps": DIST_HYB / hyb_s, "knn_max_err": worst}


def phase_dist_agg(sh, ix, dev, smi) -> dict:
    """Phase 15(d): `dist_aggregate` of COUNT/SUM/AVG and of MIN/MAX/COUNT
    by @grp, over '*' and a tag filter, against `run_aggregate` on the
    single index; each kind with the launch counters zeroed just before
    and read just after: the sums kind must launch B4, the min/max kind
    B5 (both `gb_single_kernel`, counted in SINGLE_LAUNCHES)."""
    kinds = {
        "sums": [("COUNT", [], "n"), ("SUM", ["@price"], "s"),
                 ("AVG", ["@price"], "a")],
        "minmax": [("MIN", ["@price"], "lo"), ("MAX", ["@price"], "hi"),
                   ("COUNT", [], "n")]}
    out = {}
    for kind, reds in kinds.items():
        reqs = [rt.AggregateRequest(q).group_by("@grp", *reds)
                for q in ("*", "@cat:{cat03}")]
        zero_counts()
        t0 = time.perf_counter()
        dres = [sh.aggregate(r) for r in reqs]
        torch.cuda.synchronize(dev)
        sec = time.perf_counter() - t0
        counts = {"B4" if kind == "sums" else "B5": GB.SINGLE_LAUNCHES,
                  "B3": GB.LAUNCHES, "B1": IK.LAUNCHES,
                  "B2": IK.PHRASE_LAUNCHES}
        paths = dict(AP.AGG_PATH_STATS)
        if GB.SINGLE_LAUNCHES <= 0:
            raise AssertionError(f"dist aggregate {kind}: no B4/B5 launch "
                                 f"({counts}, {paths})")
        for req, d in zip(reqs, dres):
            s = AP.run_aggregate(ix, req)
            want = {r["grp"]: r for r in s.rows}
            got = {r["grp"]: r for r in d.rows}
            if d.total != s.total or want.keys() != got.keys() or \
                    not got:
                raise AssertionError(f"dist aggregate {kind} "
                                     f"{req.query!r}: {d.total} groups "
                                     f"{len(got)} vs {s.total} {len(want)}")
            for g, w in want.items():
                for key, v in w.items():
                    x = got[g][key]
                    ok = (x == v if key in ("grp", "n", "lo", "hi")
                          else abs(x - v) <= 1e-5 * abs(v))
                    if not ok:
                        raise AssertionError(f"dist aggregate {kind} "
                                             f"{req.query!r} {g} {key}: "
                                             f"{x} vs {v}")
        out[kind] = {"launches": counts, "paths": paths,
                     "ms": sec * 1e3 / len(reqs)}
        log(f"phase dist: dist_aggregate {kind} ({', '.join(r[0] for r in reds)}"
            f" by @grp, '*' and @cat:{{cat03}}) == run_aggregate on the "
            f"single index ({' and '.join(str(len(d.rows)) for d in dres)} "
            f"groups; counts, MIN, MAX exact, SUM/AVG "
            f"rtol 1e-5); launches {counts}; shard paths {paths}; "
            f"{sec * 1e3 / len(reqs):.1f} ms a request [{smi}]")
    return out


def phase_dist_kmeans(dev, smi) -> dict:
    """Phase 15(e): `kmeans_step_sharded` over 4 slots on KM_N x KM_D
    seeded rows and KM_C centroids against `kmeans_step` on the whole."""
    from redisearch_tpu_torch.ops import ivf as IVF
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(KM_N, KM_D, generator=g, device=dev)
    cents = x[torch.randperm(KM_N, generator=g, device=dev)[:KM_C]] + 0.01
    mesh = D.make_mesh(DIST_SHARDS)
    xs = [part.contiguous() for part in x.chunk(DIST_SHARDS)]
    new = IVF.kmeans_step_sharded(mesh, xs, cents)
    sec = timed(lambda: IVF.kmeans_step_sharded(mesh, xs, cents), dev)
    whole, assign, _shift = IVF.kmeans_step(x, cents)
    whole_s = timed(lambda: IVF.kmeans_step(x, cents), dev)
    moved = int((torch.cat([IVF._lloyd_sums(p, cents)[0] for p in xs])
                 != assign).sum())
    rel = float(((new - whole).norm(dim=1)
                 / whole.norm(dim=1).clamp(min=1e-30)).max())
    log(f"phase dist: kmeans_step_sharded {KM_N:,} x {KM_D} over "
        f"{DIST_SHARDS} slots, {KM_C} centroids: max relative centroid "
        f"difference to kmeans_step on the whole {rel:.2e} (<= 1e-4); "
        f"{moved} rows assigned differently; {sec * 1e3:.2f} ms against "
        f"{whole_s * 1e3:.2f} ms whole [{smi}]")
    if rel > 1e-4 or not bool(torch.isfinite(new).all()):
        raise AssertionError(f"sharded k-means: relative difference {rel}")
    return {"rel": rel, "moved": moved, "ms": sec * 1e3,
            "whole_ms": whole_s * 1e3}


def phase_dist(main, vctx, dev, smi) -> dict:
    """Phase 15 (see the docstring) on the 1M-doc index, the 500k x 384
    index, seeded k-means rows and the dry run, all on the one card."""
    from redisearch_tpu_torch.parallel.dryrun import dryrun_multichip
    t0 = time.perf_counter()
    log(f"phase dist: torch.cuda.device_count()={torch.cuda.device_count()}"
        f", {DIST_SHARDS} slots on the card(s) round-robin")
    srch = phase_dist_search(main, dev, smi)
    agg = phase_dist_agg(srch.pop("shards"), main["ix"], dev, smi)
    vec = phase_dist_vector(vctx, dev, smi)
    km = phase_dist_kmeans(dev, smi)
    dryrun_multichip(DIST_SHARDS)
    torch.cuda.empty_cache()
    out = {"search": srch, "aggregate": agg, "vector": vec, "kmeans": km,
           "seconds": time.perf_counter() - t0}
    log("phase dist: json " + json.dumps(out))
    return out


# --------------------------------------------------------------- phase 8
#: PCIe Gen5 x16 (the H100 SXM's host link), bytes a second each way
PCIE_BYTES_PER_S = 64e9


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


# -------------------------------------------------------------- phase 16
#: the bench's progress keys that carry a parity check
BENCH_CHECKED = ([f"bm25__{f}" for f in FAMILIES]
                 + ["agg_groupby_qps", "agg_star_qps", "flat_knn_qps",
                    "ann_sweep"]
                 + [f"fknn__{f}" for f in ("fulltext", "numeric", "tag")]
                 + ["hybrid__rrf", "hybrid__linear", "wire_qps", "cold"])


def phase_bench(dev) -> dict:
    """Phase 16 (see the docstring)."""
    from redisearch_tpu_torch.bench import run as BR
    t0 = time.perf_counter()
    board, rc = BR.run(BR.SECTIONS, dev, BR.SMOKE, reps=1)
    ex = board["extra"]
    log(f"phase bench: BENCH_SMOKE shapes, sections "
        f"{ {k: round(v, 1) for k, v in ex['section_s'].items()} } s, "
        f"rc {rc}, kernel_hit_pct {ex.get('kernel_hit_pct')}, and2 "
        f"{board['value']:.1f} qps (one measurement, not a cell)")
    log("phase bench: parity " + json.dumps(ex["parity"]))
    missing = [k for k in BENCH_CHECKED if k not in ex["parity"]]
    if rc or ex.get("section_rc") or missing:
        raise AssertionError(f"bench: rc {rc}, {ex.get('section_rc')}, "
                             f"numbers without a parity check {missing}")
    if ex.get("kernel_hit_pct") != 100.0:
        raise AssertionError(f"bench: FT.SEARCH families off the kernels: "
                             f"{ex['routes'].get('kernel_hit_pct')}")
    log(f"phase bench: wire {ex['wire_qps']:.1f} qps, micro-batches "
        f"{ex['wire_batch_sizes'][-1]}; cold and2 "
        f"{ex['cold']['hbm']['and2_qps']:.1f} / "
        f"{ex['cold']['host']['and2_qps']:.1f} qps hot / cold, routes "
        f"{ex['routes']['cold']}")
    log(f"phase bench: done in {time.perf_counter() - t0:.1f}s")
    return board


# -------------------------------------------------------------- phase 17
def phase_bench_scripts(dev) -> None:
    """Phase 17 (see the docstring)."""
    from redisearch_tpu_torch.bench import device_smoke as DS
    from redisearch_tpu_torch.bench import intersect_micro as IM
    from redisearch_tpu_torch.bench import phrase_ab as PA
    t0 = time.perf_counter()
    checked, diffs = DS.compare(DS.digest(dev), DS.digest("cpu"))
    if diffs:
        raise AssertionError(f"device_smoke: the card's digest differs "
                             f"from the CPU's: {diffs}")
    log(f"phase bench-scripts: device_smoke --compare: {checked} values "
        f"of the card's digest == the CPU's (keys, order and totals "
        f"equal, numbers within {DS.TOL})")
    rng = np.random.default_rng(0)
    args = tuple(torch.from_numpy(a).to(dev)
                 for a in IM.make_windows(rng, 512, 2048, 8192))
    for k in (16, 1):
        r = IM.point(args, 2048, 8192, k, dev)
        log(f"phase bench-scripts: intersect_micro B=512 Wp=2048 Wm=8192 "
            f"k={k}: == intersect_plain lane for lane ({r['matches']} "
            f"matches); device {r['device_us_q']:.4f} us/q, wall "
            f"{r['wall_us_q']:.4f} us/q, bound {r['bound_us_q']:.6f}")
    npargs, Ws, PWs = PA.build(rng, 2048, 2048, 0.5, 2)
    r = PA.shape(tuple(torch.from_numpy(a).to(dev) for a in npargs), Ws,
                 PWs, dev)
    log(f"phase bench-scripts: phrase_ab W=(2048, 2048) fill 0.5 tf 2: "
        f"phrase, phrase raw and and2 == their plain versions; device "
        f"{r['phrase']['device_us_q']:.4f} / "
        f"{r['phrase_raw']['device_us_q']:.4f} / "
        f"{r['and2']['device_us_q']:.4f} us/q (ratio {r['ratio']:.2f})")
    log(f"phase bench-scripts: done in {time.perf_counter() - t0:.1f}s")


def main():
    smi = phase_card()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    phase_build()
    err3, err3_raw = phase_kernel_vs_plain(dev)
    err3_phrase = phase_phrase_vs_plain(dev)
    err_gb3 = phase_groupby_vs_plain(dev)
    err_sums3, err_mm3 = phase_single_groupby_vs_plain(dev)
    probe_recs = phase_probes(dev, smi)
    main = phase_main_path(dev, N_DOCS, BATCH)
    agg = phase_aggregate(main["client"], main["ix"], dev)
    star = phase_agg_star(main["client"], main["ix"], dev)
    mm = phase_agg_minmax(main["client"], main["ix"], dev)
    single = phase_single_groupby_times(main["ix"], dev, mm["windows"])
    phase_cursor(main["client"], main["ix"], dev)
    phase_wire(main, dev)
    phase_surface(main, dev)
    vec = phase_vector(dev)
    vctx = vec.pop("index")
    phase_hybrid(dev, vctx)
    del vec
    phase_dist(main, vctx, dev, smi)
    del vctx
    torch.cuda.empty_cache()
    phase_ann(dev)
    phase_geo(dev)
    phase_cold(dev, main)
    life_err = phase_lifecycle(dev, main)["served"]["err"]
    torch.cuda.empty_cache()
    phase_bench(dev)
    phase_bench_scripts(dev)
    k_ms, p_ms, k_err, k_b = main["times"]["intersect"]
    wk_ms, wp_ms, wk_err, wk_b = main["times"]["intersect_wide"]
    pk_ms, pp_ms, pk_err, pk_b = main["times"]["phrase"]
    here = os.path.dirname(os.path.abspath(__file__))
    jax_dirs = tuple(os.path.join(here, d) + os.sep
                     for d in ("redisearch_tpu", "benchmarks"))
    loaded = [m for m, mod in list(sys.modules.items())
              if m == "jax" or m.startswith("jax.")
              or m == "redisearch_tpu" or m.startswith("redisearch_tpu.")
              or m == "benchmarks" or m.startswith("benchmarks.")
              or (getattr(mod, "__file__", None) or "").startswith(jax_dirs)]
    if loaded:
        raise AssertionError(f"JAX-side modules were imported: {loaded}")
    log("phase modules: no jax module and no module file under "
        "redisearch_tpu/ or benchmarks/ was loaded")

    def rec(name, source, replaces, launches, err, ms, plain_ms, b,
            library_ms):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": b, "bound_by": "bytes", "library_ms": library_ms}

    ss, sm = single["groupby_sums"], single["groupby_minmax"]
    log(f"phase total: {time.perf_counter() - _T0:.1f}s")
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
            max(err_mm3, sm[4]), *sm[:4])] + probe_recs}))
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

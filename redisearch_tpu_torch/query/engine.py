"""Query planner and batched executor for the torch port.

Counterpart of `redisearch_tpu/query/engine.py`.  That file imports jax,
so its host-only planner cannot be shared through `_host`; the planner
below is a copy of it, kept as it is so that a query binds to the same
slots, window buckets and transport rows in both packages (a test pins
the rows byte for byte):

* the leaf classes, `QueryOptions`, `SegmentBinding` and `CompiledQuery`
  with `bind` / `bind_row`;
* `_kernel_plan` and `_kernel_seg_ok`, `_layout_of` and `_pack_into`, and
  the slop-scorer helpers `bind` consults.

Two spots differ: the BM25 avgdl fallback reads the segment's host
mirror of the doc lengths, and `decode_blob` (vector payloads) raises
"not ported yet".

The executor is the kernel branch of the JAX executor: `execute_batch`
-> `_prep_subs` (bind rows, group by structure and buckets) ->
`_KernelExecutor.run` (one upload of the group's rows, unpack on the
device, `ops.intersect.intersect_batch`, phase merge with `iter_topk`)
-> `_BatchHandle.result`.  A group the kernel does not serve raises
`NotImplementedError`; the general window path is ROADMAP A6.
"""

from __future__ import annotations

import dataclasses
import math
import time as _time
from typing import Any, Optional

import numpy as np
import torch

from .._host.analysis.stemmer import Stemmer
from .._host.query import ast, expand
from .._host.schema import FieldType, Schema
from .._host.utils import wkt
from .._host.utils.errors import (FieldNotFound, QuerySyntaxError,
                                  WrongFieldType)
from ..index.segment import Segment, next_pow2
from ..ops import intersect as IK

# ---------------------------------------------------------------------------
# IR (static structure — everything here keys the compile cache)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LTerms:
    """Union of term slots [lo, hi): a token + its expansions, or an
    affix/fuzzy/wildcard expansion group."""
    lo: int
    hi: int


@dataclasses.dataclass(frozen=True)
class LPhrase:
    slots: tuple[int, ...]     # one slot per phrase position
    slop: int
    inorder: bool
    score_lo: int              # slots contributing to the score
    score_hi: int


@dataclasses.dataclass(frozen=True)
class LTag:
    field: str
    ord: int                   # tag leaf ordinal (keys dynamic arrays)
    n_slots: int               # padded value-slot count (pow2)


@dataclasses.dataclass(frozen=True)
class LNumeric:
    ord: int
    field: str
    lo_excl: bool
    hi_excl: bool


@dataclasses.dataclass(frozen=True)
class LGeo:
    ord: int
    field: str


@dataclasses.dataclass(frozen=True)
class LVecRange:
    ord: int
    field: str
    metric: str


@dataclasses.dataclass(frozen=True)
class LHostMask:
    """Geometry predicates / explicit id lists: host-computed bool mask."""
    ord: int


@dataclasses.dataclass(frozen=True)
class LMissing:
    field: str


@dataclasses.dataclass(frozen=True)
class LAll:
    pass


@dataclasses.dataclass(frozen=True)
class LNone:
    pass


# tree nodes: ("and"|"or"|"dismax", (kids...)) | ("not"|"opt", kid)
# | ("leaf", leaf_obj, leaf_index)


# ---------------------------------------------------------------------------
# Compiled query
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class QueryOptions:
    scorer: str = "BM25STD"        # BM25STD|BM25STD.TANH|TFIDF|TFIDF.DOCNORM
    #                                |DISMAX|DOCSCORE
    k: int = 10                    # offset+num results wanted
    sort_field: Optional[str] = None
    sort_asc: bool = True
    slop: int = -1                 # global SLOP request arg
    inorder: bool = False
    # epoch seconds for TTL filtering; defaults to the real clock so no
    # call site can accidentally run TTL checks against t=0
    now: int = dataclasses.field(
        default_factory=lambda: int(_time.time()))
    max_expansions: int = expand.DEFAULT_MAX_EXPANSIONS
    min_prefix: int = expand.DEFAULT_MIN_PREFIX
    language: str = "english"
    verbatim: bool = False         # disable stemming expansion
    with_vector_scores: bool = True
    expander: str = ""             # custom expander name (ext.py), "" = default
    # NOSTOPWORDS: keep stopwords as query terms (reference: RSSearchOptions
    # flag Search_NoStopwrods, parsed in aggregate_request.c)
    nostopwords: bool = False
    # INFIELDS: default TEXT field mask for terms without an explicit
    # @field modifier (reference: RSSearchOptions fieldmask)
    in_fields: Optional[tuple] = None
    # BM25STD.TANH stretch: score = tanh(bm25 / factor)
    # (reference: tanhStretched, ext/default.c; BM25STD_TANH_FACTOR=4)
    tanh_factor: float = 4.0


@dataclasses.dataclass
class SegmentBinding:
    """Dynamic argument pack for one segment."""
    seg: Segment
    dyn: dict[str, Any]
    # bind-time notices (e.g. exact slow path engaged for a phrase over
    # an ultra-common term) — surfaced on SearchResult.warnings
    warnings: tuple = ()


class CompiledQuery:
    """Static structure + per-segment dynamic bindings."""

    def __init__(self, schema: Schema, root: ast.Node, opts: QueryOptions,
                 synonyms=None):
        self.schema = schema
        self.opts = opts
        self._syn = synonyms
        # slot tables filled during lowering
        self.term_strings: list[str] = []     # slot -> index term
        self.term_qmasks: list[int] = []      # slot -> field bitmask
        self.term_weights: list[float] = []   # slot -> query weight
        self.tag_leaves: list[tuple[str, list[str], float]] = []
        #   (field attr, value patterns..., weight) resolved at bind
        self.tag_nodes: list[ast.TagNode] = []
        self.num_bounds: list[tuple[float, float]] = []
        self.geo_params: list[tuple[float, float, float]] = []
        self.vec_blobs: list[np.ndarray] = []
        self.vec_blob_params: list = []       # $param names for rebinding
        self.vec_blob_fields: list = []       # Field per blob (dtype)
        self.vec_radii: list[float] = []
        self.host_nodes: list[ast.Node] = []  # geometry/ids nodes
        self.leaf_consts: list[float] = []    # per-leaf constant score
        self._n_leaves = 0
        # KNN (top-level only)
        self.knn: Optional[ast.VectorNode] = None

        self._stemmer = None if opts.verbatim else Stemmer(opts.language)
        # Index-level stats (set by the Index layer for multi-segment
        # correctness; falls back to per-segment stats).
        self.global_N: Optional[int] = None
        self.global_avgdl: Optional[float] = None
        root = self._unwrap_knn(root)
        self.tree = self._lower(root)
        self._bind_cache: dict = {}   # seg.uid -> (dyn template, P)
        self._row_cache: dict = {}    # seg.uid -> packed-row template

    # -- lowering ---------------------------------------------------------
    def _unwrap_knn(self, node: ast.Node) -> ast.Node:
        if isinstance(node, ast.VectorNode) and node.mode == "KNN":
            self.knn = node
            return node.child if node.child is not None else ast.WildcardNode()
        return node

    def _leaf(self, leaf, const: float = 0.0):
        idx = self._n_leaves
        self._n_leaves += 1
        self.leaf_consts.append(const)
        return ("leaf", leaf, idx)

    def _qmask(self, node: ast.Node) -> int:
        attrs = node.fieldmask_attrs
        if attrs is None and self.opts.in_fields:
            # INFIELDS narrows unscoped terms; explicit @field wins
            attrs = list(self.opts.in_fields)
        return self.schema.text_field_mask(attrs)

    def _add_term_slot(self, term: str, qmask: int, weight: float) -> int:
        self.term_strings.append(term)
        self.term_qmasks.append(qmask)
        self.term_weights.append(weight)
        return len(self.term_strings) - 1

    def _lower(self, node: ast.Node):
        w = node.weight
        if isinstance(node, ast.TokenNode):
            qmask = self._qmask(node)
            phonetic = any(
                self.schema.field(a).phonetic
                for a in (node.fieldmask_attrs or [])
                if self.schema.try_field(a)
            ) if node.fieldmask_attrs else any(
                f.phonetic for f in self.schema.text_fields())
            from .._host import ext as _ext
            custom = _ext.get_expander(self.opts.expander)
            if custom is not None and not (node.verbatim
                                           or self.opts.verbatim):
                terms = list(dict.fromkeys(custom(node.term)))
            else:
                terms = expand.expand_token(
                    node.term, node.verbatim or self.opts.verbatim,
                    self._stemmer, self._syn, phonetic)
            lo = len(self.term_strings)
            for t in terms:
                self._add_term_slot(t, qmask, w)
            return self._leaf(LTerms(lo, len(self.term_strings)))
        if isinstance(node, (ast.AffixNode, ast.FuzzyNode,
                             ast.WildcardQueryNode)):
            qmask = self._qmask(node)
            lo = len(self.term_strings)
            # slots are reserved now; actual terms resolved at bind time
            # (per segment dict).  Reserve a pow2 bucket of slots.
            n = next_pow2(min(self.opts.max_expansions, 256))
            for _ in range(n):
                self._add_term_slot("", qmask, w)
            self._expansion_nodes = getattr(self, "_expansion_nodes", {})
            self._expansion_nodes[lo] = node
            return self._leaf(LTerms(lo, len(self.term_strings)))
        if isinstance(node, ast.PhraseNode):
            qmask = self._qmask(node)
            slots = []
            lo = len(self.term_strings)
            for t in node.terms:
                if not isinstance(t, ast.TokenNode):
                    raise QuerySyntaxError(
                        "phrase members must be plain terms")
                slots.append(self._add_term_slot(t.term, qmask, w))
            slop = node.slop if not node.exact else 0
            inorder = node.inorder or node.exact
            return self._leaf(LPhrase(tuple(slots), slop, inorder, lo,
                                      len(self.term_strings)))
        if isinstance(node, ast.IntersectNode):
            if self.opts.slop >= 0:
                # global SLOP: token-only intersections become phrases
                toks = [k for k in node.kids if isinstance(k, ast.TokenNode)]
                if len(toks) == len(node.kids) and len(toks) > 1:
                    ph = ast.PhraseNode(
                        terms=toks, exact=False, slop=self.opts.slop,
                        inorder=self.opts.inorder,
                        fieldmask_attrs=node.fieldmask_attrs)
                    return self._lower(ph)
            return ("and", tuple(self._lower(k) for k in node.kids))
        if isinstance(node, ast.UnionNode):
            op = "dismax" if self.opts.scorer == "DISMAX" else "or"
            return (op, tuple(self._lower(k) for k in node.kids))
        if isinstance(node, ast.NotNode):
            return ("not", self._lower(node.child))
        if isinstance(node, ast.OptionalNode):
            return ("opt", self._lower(node.child))
        if isinstance(node, ast.TagNode):
            field = self.schema.field(node.field)
            if field.type != FieldType.TAG:
                raise WrongFieldType(f"@{node.field} is not a TAG field")
            ordn = len(self.tag_nodes)
            self.tag_nodes.append(node)
            n_slots = next_pow2(max(
                len(node.kids),
                min(self.opts.max_expansions, 256)
                if any(not isinstance(k, ast.TokenNode) for k in node.kids)
                else len(node.kids)))
            return self._leaf(LTag(field.attribute, ordn, n_slots), const=w)
        if isinstance(node, ast.NumericNode):
            field = self.schema.field(node.field)
            if field.type != FieldType.NUMERIC:
                raise WrongFieldType(f"@{node.field} is not NUMERIC")
            ordn = len(self.num_bounds)
            self.num_bounds.append((node.lo, node.hi))
            return self._leaf(
                LNumeric(ordn, field.attribute, node.lo_excl, node.hi_excl),
                const=w)
        if isinstance(node, ast.GeoNode):
            field = self.schema.field(node.field)
            if field.type != FieldType.GEO:
                raise WrongFieldType(f"@{node.field} is not GEO")
            unit_m = {"m": 1.0, "km": 1000.0, "mi": 1609.34, "ft": 0.3048}
            ordn = len(self.geo_params)
            self.geo_params.append((math.radians(node.lon),
                                    math.radians(node.lat),
                                    node.radius * unit_m[node.unit]))
            return self._leaf(LGeo(ordn, field.attribute), const=w)
        if isinstance(node, ast.GeometryNode):
            field = self.schema.field(node.field)
            if field.type != FieldType.GEOMETRY:
                raise WrongFieldType(f"@{node.field} is not GEOMETRY")
            ordn = len(self.host_nodes)
            self.host_nodes.append(node)
            return self._leaf(LHostMask(ordn), const=w)
        if isinstance(node, ast.IdsNode):
            ordn = len(self.host_nodes)
            self.host_nodes.append(node)
            return self._leaf(LHostMask(ordn), const=w)
        if isinstance(node, ast.VectorNode):
            if node.mode != "RANGE":
                raise QuerySyntaxError("KNN must be a top-level expression")
            field = self.schema.field(node.field)
            if field.type != FieldType.VECTOR:
                raise WrongFieldType(f"@{node.field} is not VECTOR")
            ordn = len(self.vec_blobs)
            self.vec_blobs.append(decode_blob(node.blob, field))
            self.vec_blob_params.append(node.blob_param)
            self.vec_blob_fields.append(field)
            self.vec_radii.append(float(node.radius))
            return self._leaf(
                LVecRange(ordn, field.attribute,
                          field.vector.metric.value), const=w)
        if isinstance(node, ast.MissingNode):
            field = self.schema.field(node.field)
            if not field.indexmissing:
                raise QuerySyntaxError(
                    f"field {node.field} not indexed with INDEXMISSING")
            return self._leaf(LMissing(field.attribute), const=w)
        if isinstance(node, ast.WildcardNode):
            return self._leaf(LAll(), const=w)
        if isinstance(node, ast.EmptyNode):
            return self._leaf(LNone())
        raise QuerySyntaxError(f"cannot lower {type(node).__name__}")

    def set_synonyms(self, syn):
        self._syn = syn
        self._bind_cache.clear()
        self._row_cache.clear()

    # -- signature (compile-cache key) -----------------------------------
    @property
    def tree_sig(self) -> str:
        """Structure fingerprint: identical iff two queries can share one
        compiled executable (same lowered tree/scorer/sort/knn shape)."""
        ts = getattr(self, "_tree_str", None)
        if ts is None:
            # stringifying the lowered tree is O(tree) — memoize it; the
            # rest of the key is cheap per call
            ts = self._tree_str = (
                f"{self.tree}|T={len(self.term_strings)}"
                f"|scorer={self.opts.scorer}"
                f"|th={self.opts.tanh_factor}"
                f"|sort={self.opts.sort_field}:{self.opts.sort_asc}"
                f"|knn={self.knn.field if self.knn else None}")
        return ts

    def signature(self, seg_sig: str, buckets: dict, P: int, k: int,
                  batch: int = 1) -> str:
        bstr = ",".join(f"{i}:{b}" for i, b in sorted(buckets.items()))
        return f"{self.tree_sig}|B[{bstr}]|P={P}|k={k}|b={batch}|{seg_sig}"

    @staticmethod
    def bucket_size(n: int) -> int:
        """Quantize a window length to a coarse bucket.

        Powers of 4 starting at 2048 (2k, 8k, 32k, 131k, 524k, 2M): a
        handful of levels keeps the compile universe tiny (each distinct
        bucket vector is one XLA executable) while per-query window
        inflation is bounded at 4x.  Small-side leaves keep small
        buckets, preserving the pivot-on-smallest intersection
        advantage.  The 2048 floor matters for serving: a zipf query
        mix's median term df is in the hundreds, and the mega-kernel's
        per-query cost (DMA rows, phase vectors, top-k extraction) scales
        with the BUCKET, not the live length.
        """
        b = 2048
        while b < n:
            b *= 4
        return b

    def leaves(self) -> list[tuple[Any, int]]:
        """All (leaf, leaf_idx) pairs of the lowered tree."""
        out = []

        def rec(t):
            if t[0] == "leaf":
                out.append((t[1], t[2]))
            elif t[0] in ("not", "opt"):
                rec(t[1])
            else:
                for k in t[1]:
                    rec(k)
        rec(self.tree)
        return out

    # -- binding ----------------------------------------------------------
    def bind(self, seg: Segment) -> tuple[SegmentBinding, int]:
        """Resolve slots against one segment, memoized per segment.

        Segments are immutable after seal, so everything bind computes is
        a pure function of (this query, segment) EXCEPT the clock and the
        vector payloads (rebound per call by prepare()).  The memo turns
        the serving hot path's per-query numpy work into one dict copy —
        bind dominated host time at batch-serving rates."""
        ent = self._bind_cache.get(seg.uid)
        if ent is None:
            binding, P = self._bind_fresh(seg)
            if len(self._bind_cache) > 64:
                self._bind_cache.clear()
            self._bind_cache[seg.uid] = (dict(binding.dyn), P,
                                         binding.warnings)
            return binding, P
        dyn_t, P, warns = ent
        dyn = dict(dyn_t)   # callers pop/add keys on their copy
        dyn["now"] = np.int32(self.opts.now)
        for i, blob in enumerate(self.vec_blobs):
            dyn[f"vblob{i}"] = blob
            dyn[f"vrad{i}"] = np.float32(self.vec_radii[i])
        if self.knn is not None:
            dyn["knn_blob"] = decode_blob(
                self.knn.blob, self.schema.field(self.knn.field))
        return SegmentBinding(seg, dyn, warns), P

    def bind_row(self, seg: Segment):
        """Bind against one segment as a packed int32 transport row.

        The serving path's binding: everything static w.r.t.
        (query, segment) — slot tables, window buckets, layout — is
        computed once and cached; each execution costs one row memcpy
        plus clock/vector-payload patches.  Returns (row, template)
        where template = (static_row, patches, layout, total, buckets,
        P2, group_sig, layout_fp): queries with equal group_sig can run
        in one batched executable over stacked rows."""
        ent = self._row_cache.get(seg.uid)
        if ent is None:
            binding, P = self.bind(seg)
            dyn = binding.dyn
            dyn.pop("_tagL", None)
            bk = dyn.pop("_buckets")
            layout, total = _layout_of(dyn)
            static = np.zeros(total, np.int32)
            _pack_into(layout, dyn, static)
            patches = tuple(
                e for e in layout
                if e[0] == "now" or e[0] == "knn_blob"
                or e[0].startswith("vblob") or e[0].startswith("vrad"))
            P2 = int(next_pow2(P))
            gsig = ((self.tree_sig,) + tuple(sorted(bk.items())) + (P2,))
            lfp = ";".join(f"{k}:{s}:{d}" for k, _, _, s, d in layout)
            ent = (static, patches, layout, total, bk, P2, gsig, lfp)
            if len(self._row_cache) > 64:
                self._row_cache.clear()
            self._row_cache[seg.uid] = ent
        static, patches = ent[0], ent[1]
        row = static.copy()
        for key, o, n, shape, dt in patches:
            if key == "now":
                row[o] = np.int32(self.opts.now)
                continue
            if key == "knn_blob":
                a = decode_blob(self.knn.blob,
                                self.schema.field(self.knn.field))
            elif key.startswith("vblob"):
                a = self.vec_blobs[int(key[5:])]
            else:                       # vrad{i}
                a = np.float32(self.vec_radii[int(key[4:])])
            a = np.asarray(a)
            if dt.startswith("float") or dt == "bfloat16":
                v = a.reshape(-1).astype(np.float32).view(np.int32)
            elif dt == "int32":
                v = a.reshape(-1)
            else:
                v = a.reshape(-1).astype(np.int32)
            row[o:o + n] = v
        return row, ent

    def _bind_fresh(self, seg: Segment) -> tuple[SegmentBinding, int]:
        """Resolve slots against one segment; returns (binding, P)."""
        opts = self.opts
        self._bind_warnings: list[str] = []
        n_slots = len(self.term_strings)
        starts = np.zeros(n_slots, np.int32)
        lens = np.zeros(n_slots, np.int32)
        from ..index.segment import mask_words, pack_mask_words
        K_words = mask_words(self.schema.num_text_fields)
        qmasks = pack_mask_words(self.term_qmasks or [0], K_words)
        if n_slots == 0:
            qmasks = (np.zeros(0, np.int32) if K_words == 1
                      else np.zeros((0, K_words), np.int32))

        # resolve dynamic expansions (affix/fuzzy/wildcard) per segment
        term_strings = list(self.term_strings)
        for lo, node in getattr(self, "_expansion_nodes", {}).items():
            terms = self._expand_node(node, seg)
            hi = lo
            while hi < n_slots and self.term_strings[hi] == "":
                hi += 1
            width = hi - lo
            for j, t in enumerate(terms[:width]):
                term_strings[lo + j] = t

        toff = seg.text.term_offsets_np
        dfs = np.zeros(n_slots, np.float64)
        for i, t in enumerate(term_strings):
            if not t:
                continue
            tid = seg.terms.lookup(t)
            if tid < 0:
                continue
            starts[i] = toff[tid]
            lens[i] = toff[tid + 1] - toff[tid]
            dfs[i] = seg.terms.doc_freq[tid]

        N = self.global_N if self.global_N else max(seg.n_docs, 1)
        idf = self._idf(dfs, N)
        tweight = (np.asarray(self.term_weights, np.float32)
                   if n_slots else np.zeros(0, np.float32))
        tweight = tweight * idf.astype(np.float32)

        L = int(next_pow2(max(int(lens.max()) if n_slots else 1, 1)))
        dyn: dict[str, Any] = {
            "tstarts": starts, "tlens": lens, "tmasks": qmasks,
            "tweight": tweight,
            "leaf_const": np.asarray(self.leaf_consts or [0.0], np.float32),
            "avgdl": np.float32(
                self.global_avgdl if self.global_avgdl
                else float(seg.doclen_np.sum()) / N),
            "now": np.int32(opts.now),
            "n_docs": np.int32(seg.n_docs),
        }

        # tags
        P_tag = 1
        for j, node in enumerate(self.tag_nodes):
            tp = seg.tags.get(self.schema.field(node.field).attribute)
            leaf = self._find_tag_leaf(j)
            ns = leaf.n_slots
            tstarts = np.zeros(ns, np.int32)
            tlens = np.zeros(ns, np.int32)
            # -2 = unbound slot: never equals a real value id, nor the -1
            # "doc has no value" marker in the dense codes column
            tqcodes = np.full(ns, -2, np.int32)
            if tp is not None:
                vals = self._expand_tag_values(node, tp)
                for a, v in enumerate(vals[:ns]):
                    vid = tp.ids.get(v, -1)
                    if vid >= 0:
                        tstarts[a] = tp.offsets_np[vid]
                        tlens[a] = tp.offsets_np[vid + 1] - tp.offsets_np[vid]
                        tqcodes[a] = vid
                P_tag = max(P_tag, int(tlens.max()) if ns else 1)
            dyn[f"tag{j}_starts"] = tstarts
            dyn[f"tag{j}_lens"] = tlens
            dyn[f"tag{j}_qcodes"] = tqcodes
        dyn["_tagL"] = P_tag  # popped before jit

        # numerics / geo
        numw_start = np.zeros(max(len(self.num_bounds), 1), np.int32)
        numw_len = np.zeros(max(len(self.num_bounds), 1), np.int32)
        if self.num_bounds:
            dyn["num_lo"] = np.asarray([b[0] for b in self.num_bounds],
                                       np.float32)
            dyn["num_hi"] = np.asarray([b[1] for b in self.num_bounds],
                                       np.float32)
        if self.geo_params:
            dyn["geo_lon"] = np.asarray([g[0] for g in self.geo_params],
                                        np.float32)
            dyn["geo_lat"] = np.asarray([g[1] for g in self.geo_params],
                                        np.float32)
            dyn["geo_rad"] = np.asarray([g[2] for g in self.geo_params],
                                        np.float32)
        for i, blob in enumerate(self.vec_blobs):
            dyn[f"vblob{i}"] = blob
            dyn[f"vrad{i}"] = np.float32(self.vec_radii[i])
        if self.knn is not None:
            # per-query payload: lives in dyn so batched execution binds
            # each query's own blob (not the batch prototype's)
            dyn["knn_blob"] = decode_blob(
                self.knn.blob, self.schema.field(self.knn.field))

        # host-evaluated masks (geometry, ids)
        for i, node in enumerate(self.host_nodes):
            dyn[f"hm{i}"] = self._host_mask(node, seg)

        # position window bucket for phrase leaves (host mirror — indexing
        # the device array here would cost a transfer round trip per slot)
        P = 1
        po_np = seg.text.pos_offsets_np
        for leaf in self._phrase_leaves(self.tree):
            for s in leaf.slots:
                if lens[s] > 0 and po_np is not None:
                    a = int(starts[s])
                    b = a + int(lens[s])
                    P = max(P, int(po_np[b]) - int(po_np[a]))
        from ..index.segment import POS_SLICE_PAD
        P = min(int(self.bucket_size(P)), POS_SLICE_PAD) if P > 1 else 1

        # ---- per-leaf window buckets (static shapes for the window
        # evaluator; part of the compile-cache key)
        cap = int(next_pow2(seg.n_pad))
        buckets: dict[int, tuple] = {}
        tweight = dyn["tweight"]
        for leaf, idx in self.leaves():
            if isinstance(leaf, LTerms):
                lo, hi = leaf.lo, leaf.hi
                # compact non-empty slots to the front of the leaf range so
                # a static prefix covers every live expansion
                rng = list(range(lo, hi))
                nz = [i for i in rng if lens[i] > 0]
                perm = nz + [i for i in rng if lens[i] == 0]
                for arr in (starts, lens, qmasks, tweight):
                    arr[lo:hi] = arr[perm]
                nu = next_pow2(max(len(nz), 1))
                W = min(self.bucket_size(
                    int(lens[lo:hi].max()) if hi > lo else 1), cap)
                buckets[idx] = (min(nu, hi - lo), W)
            elif isinstance(leaf, LPhrase):
                W = min(self.bucket_size(
                    max((int(lens[s]) for s in leaf.slots), default=1)), cap)
                # per-slot position counts -> pivot on the rarest term so
                # the candidate set is the smallest position list
                po = seg.text.pos_offsets_np
                ncounts = []
                for s_ in leaf.slots:
                    a = int(starts[s_])
                    b = a + int(lens[s_])
                    ncounts.append(int(po[b] - po[a]) if lens[s_] > 0
                                   else 0)
                pos_counts = [c if c > 0 else 10**9 for c in ncounts]
                # in-order chains anchor on term 0 (reference walks
                # children in query order with a running span check);
                # unordered chains pivot on the rarest term
                pivot_j = 0 if leaf.inorder else int(
                    np.argmin(pos_counts))
                from ..index.segment import POS_SLICE_PAD as _PSP
                # members past the window cap probe the poskeys CSR by
                # dynamic binary search; a pivot past the cap scans its
                # run in chunks — NO truncation either way
                bigs = tuple(bool(c > _PSP) for c in ncounts)
                big_rounds = tuple(
                    max(int(np.ceil(np.log2(c + 1))), 1) if b else 0
                    for c, b in zip(ncounts, bigs))
                Pc = min(self.bucket_size(max(ncounts[pivot_j], 1)), _PSP)
                n_chunks = (
                    -(-ncounts[pivot_j] // Pc) if bigs[pivot_j] else 1)
                small = [c for j, c in enumerate(ncounts)
                         if j != pivot_j and not bigs[j]]
                Pm = min(self.bucket_size(max(max(small, default=1), 1)),
                         _PSP)
                if n_chunks > 1 or any(bigs):
                    self._bind_warnings.append(
                        "phrase over ultra-common term: exact slow path "
                        f"engaged (positions={max(ncounts)})")
                buckets[idx] = (W, Pc, Pm, pivot_j, bigs, big_rounds,
                                n_chunks)
            elif isinstance(leaf, LTag):
                ts = dyn[f"tag{leaf.ord}_starts"]
                tl = dyn[f"tag{leaf.ord}_lens"]
                nz = np.nonzero(tl > 0)[0]
                perm = np.concatenate([nz, np.nonzero(tl == 0)[0]])
                dyn[f"tag{leaf.ord}_starts"] = ts[perm]
                dyn[f"tag{leaf.ord}_lens"] = tl[perm]
                dyn[f"tag{leaf.ord}_qcodes"] = \
                    dyn[f"tag{leaf.ord}_qcodes"][perm]
                nu = next_pow2(max(len(nz), 1))
                W = min(self.bucket_size(int(tl.max()) if tl.size else 1),
                        cap)
                buckets[idx] = (min(nu, len(tl)), W)
            elif isinstance(leaf, LNumeric):
                col = seg.numerics.get(leaf.field)
                length = 0
                multi = bool(col is not None and col.multi)
                capN = cap
                if col is not None and col.sorted_vals_np is not None:
                    lo_v, hi_v = self.num_bounds[leaf.ord]
                    sv = col.sorted_vals_np
                    a = np.searchsorted(
                        sv, lo_v, side="right" if leaf.lo_excl else "left")
                    b = np.searchsorted(
                        sv, hi_v, side="left" if leaf.hi_excl else "right")
                    length = max(int(b - a), 0)
                    numw_start[leaf.ord] = a
                    numw_len[leaf.ord] = length
                    if multi:
                        # the expanded (value,doc) run can exceed n_pad
                        capN = int(next_pow2(max(len(sv), 1)))
                buckets[idx] = (min(self.bucket_size(length), capN), multi)
            elif isinstance(leaf, LVecRange):
                colv = seg.vectors.get(leaf.field)
                buckets[idx] = (bool(colv is not None and colv.multi),)
            else:
                buckets[idx] = ()
        # GetSlop divisor buckets (TFIDF/TFIDF.DOCNORM/legacy BM25): per
        # root-child, per-slot position-window sizes.  Computed AFTER the
        # LTerms slot compaction above so indices line up with the
        # compacted dyn arrays.
        if self.opts.scorer in _SLOP_SCORERS:
            slop_info = _slop_root_children(self.tree)
            if slop_info is not None:
                from ..index.segment import POS_SLICE_PAD as _PSP2
                sb = []
                for ch in slop_info[1]:
                    if ch[0] != "slots":
                        sb.append(())
                        continue
                    per = []
                    for s_ in ch[1]:
                        c = 0
                        if lens[s_] > 0 and po_np is not None:
                            a = int(starts[s_])
                            b = a + int(lens[s_])
                            c = int(po_np[b]) - int(po_np[a])
                        per.append(min(self.bucket_size(max(c, 1)), _PSP2))
                    sb.append(tuple(per))
                buckets[-1] = tuple(sb)

        dyn["numw_start"] = numw_start
        dyn["numw_len"] = numw_len
        dyn["_buckets"] = buckets  # popped before jit

        return SegmentBinding(seg, dyn, tuple(self._bind_warnings)), P

    def _idf(self, dfs: np.ndarray, N: int) -> np.ndarray:
        if self.opts.scorer == "DISMAX":
            # reference dismaxRecursive: term score = weight * freq —
            # no idf at all (ext/default.c:377-455)
            return np.ones_like(dfs)
        if self.opts.scorer == "BM25":
            # the legacy BM25 scorer uses the logb idf, not the BM25 idf
            # (ext/default.c bm25Recursive: QueryTerm_GetIDF) — fall
            # through to the TFIDF branch below
            pass
        elif self.opts.scorer.startswith("BM25"):
            # BM25 idf (reference idf crate: ln(1 + (N-n+0.5)/(n+0.5)))
            return np.log1p((N - dfs + 0.5) / (dfs + 0.5)).clip(min=0.0)
        # TFIDF idf = logb(1 + (N+1)/max(df,1)): the BINARY EXPONENT, a
        # step function — not a smooth log2 (reference idf crate
        # calculate_idf, idf/src/lib.rs: ilogb of the frequency ratio).
        # frexp is exact where log2().floor() can be off by one near
        # powers of two (the crate makes the same point).
        v = 1.0 + (N + 1) / np.maximum(dfs, 1.0)
        _m, e = np.frexp(v)
        return (e - 1).astype(np.float64)

    def _expand_node(self, node: ast.Node, seg: Segment) -> list[str]:
        st = seg.terms.sorted_terms
        if isinstance(node, ast.AffixNode):
            if len(node.text) < self.opts.min_prefix:
                return []
            return expand.expand_affix(st, node.text, node.prefix,
                                       node.suffix, self.opts.max_expansions)
        if isinstance(node, ast.FuzzyNode):
            return expand.expand_fuzzy(seg.terms, node.term, node.max_dist,
                                       self.opts.max_expansions)
        if isinstance(node, ast.WildcardQueryNode):
            return expand.expand_wildcard(st, node.pattern,
                                          self.opts.max_expansions)
        return []

    def _expand_tag_values(self, node: ast.TagNode, tp) -> list[str]:
        field = self.schema.field(node.field)
        out = []
        for k in node.kids:
            if isinstance(k, ast.TokenNode):
                v = k.term if field.casesensitive else k.term.lower()
                out.append(v.strip())
            elif isinstance(k, ast.AffixNode):
                out.extend(expand.expand_affix(
                    tp.sorted_values, k.text, k.prefix, k.suffix,
                    self.opts.max_expansions))
            elif isinstance(k, ast.WildcardQueryNode):
                out.extend(expand.expand_wildcard(
                    tp.sorted_values, k.pattern, self.opts.max_expansions))
            elif isinstance(k, ast.FuzzyNode):
                # fuzzy over tag values: brute force (tag dicts are small)
                out.extend([v for v in tp.sorted_values
                            if _lev(k.term, v) <= k.max_dist]
                           [:self.opts.max_expansions])
        return out

    def _host_mask(self, node: ast.Node, seg: Segment) -> np.ndarray:
        mask = np.zeros(seg.n_pad, bool)
        if isinstance(node, ast.GeometryNode):
            f = self.schema.field(node.field)
            shapes = seg.geometries.get(f.attribute)
            if shapes:
                q = wkt.parse(node.wkt)
                pred = wkt.PREDICATES[node.predicate]
                # geographic (SPHERICAL) is the reference default
                # (spec.c:1261-1265); FLAT is opt-in cartesian
                sph = (f.geometry.system != "FLAT"
                       if f.geometry is not None else True)
                for i, s in enumerate(shapes):
                    if s is not None and pred(s, q, spherical=sph):
                        mask[i] = True
        elif isinstance(node, ast.IdsNode):
            for key in node.keys:
                # resolved by the Index layer (gid -> local); see index.py
                pass
        return mask

    def _find_tag_leaf(self, ordn: int) -> LTag:
        for leaf in self._iter_leaves(self.tree):
            if isinstance(leaf, LTag) and leaf.ord == ordn:
                return leaf
        raise AssertionError

    def _iter_leaves(self, tree):
        tag = tree[0]
        if tag == "leaf":
            yield tree[1]
        elif tag in ("not", "opt"):
            yield from self._iter_leaves(tree[1])
        else:
            for k in tree[1]:
                yield from self._iter_leaves(k)

    def _phrase_leaves(self, tree):
        return [l for l in self._iter_leaves(tree) if isinstance(l, LPhrase)]


def _lev(a: str, b: str) -> int:
    if abs(len(a) - len(b)) > 3:
        return 4
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1,
                           prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


def _kernel_plan(cq0: CompiledQuery, seg: Segment, bk: dict, k_pad: int):
    """Eligibility for the term-query intersection kernel
    (ops/intersect.py).  Returns (slot_descs, Ws, groups, pivot_g,
    aux_keys) or None.  Covered: BM25STD top-k over AND/OR/NOT/OPT of
    term groups with 1..4 live slots each (stem/synonym-expanded tokens
    included), plus TAG leaves inside intersections (sorted doc windows
    streamed from the tag postings array, hit-only members scoring the
    leaf constant once per doc), on a clean segment — the serving hot
    path.  slot_descs: ("t", term_slot) or ("g", tag_ord, value_j,
    leaf_idx); aux_keys name the segment-arg arrays the tag slots read
    from."""
    if not _kernel_seg_ok(cq0, seg, k_pad):
        return None

    def leaf_group(t, flag):
        if t[0] != "leaf" or not isinstance(t[1], LTerms):
            return None
        e = bk.get(t[2])
        if not e:
            return None
        nu, W = e
        if not 1 <= nu <= 4:
            return None
        return (flag, [("t", t[1].lo + j) for j in range(nu)],
                [W] * nu, -1)

    aux_ords: list[int] = []
    dense_descs: list = []          # (flag, ord, nv, leaf_idx)

    def tag_dense(t, flag):
        """Single-valued TAG leaf with a posting-aligned code column:
        becomes a dense in-kernel predicate (one window compare per
        pivot phase) instead of a member-window pass."""
        if t[0] != "leaf" or not isinstance(t[1], LTag):
            return None
        leaf, idx = t[1], t[2]
        e = bk.get(idx)
        if not e:
            return None
        nu, _W = e
        if not 1 <= nu <= 4 or len(dense_descs) >= 2:
            return None
        if seg.tag_pcodes(leaf.field) is None:
            return None
        dense_descs.append((flag, leaf.ord, nu, idx))
        return "dense"

    def tag_group(t, flag):
        if t[0] != "leaf" or not isinstance(t[1], LTag):
            return None
        leaf, idx = t[1], t[2]
        e = bk.get(idx)
        if not e:
            return None
        nu, W = e
        if not 1 <= nu <= 4:
            return None
        tp = seg.tags.get(leaf.field)   # LTag.field is the attribute
        if tp is None or tp.doc_ids.shape[0] % 128:
            return None
        if leaf.ord not in aux_ords:
            if len(aux_ords) >= 2:
                return None
            aux_ords.append(leaf.ord)
        src = aux_ords.index(leaf.ord)
        return (flag, [("g", leaf.ord, j, idx) for j in range(nu)],
                [W] * nu, src)

    tree = cq0.tree
    raw_groups = []
    if tree[0] == "leaf":
        g = leaf_group(tree, IK.REQ)
        if g is None:
            return None
        raw_groups.append(g)
    elif tree[0] == "or":
        # a union flattens to ONE group (sum-fold + first-owner dedup —
        # exactly union_windows semantics)
        if not 2 <= len(tree[1]) <= 4:
            return None
        slots_u: list = []
        ws_u: list[int] = []
        for kid in tree[1]:
            g = leaf_group(kid, IK.REQ)
            if g is None:
                return None
            slots_u += g[1]
            ws_u += g[2]
        raw_groups.append((IK.REQ, slots_u, ws_u, -1))
    elif tree[0] == "and":
        if not 2 <= len(tree[1]) <= 4:
            return None
        for kid in tree[1]:
            if kid[0] == "leaf":
                g = (leaf_group(kid, IK.REQ) or tag_dense(kid, IK.REQ)
                     or tag_group(kid, IK.REQ))
            elif kid[0] in ("not", "opt"):
                fl = IK.NOT if kid[0] == "not" else IK.OPT
                g = (leaf_group(kid[1], fl) or tag_dense(kid[1], fl)
                     or tag_group(kid[1], fl))
            else:
                g = None
            if g is None:
                return None
            if g != "dense":
                raw_groups.append(g)
        if not any(g[0] == IK.REQ and g[3] < 0 for g in raw_groups):
            return None   # the pivot must be a TEXT group
    else:
        return None

    total_slots = sum(len(g[1]) for g in raw_groups)
    if total_slots > 8:
        return None
    if sum(len(g[1]) for g in raw_groups if g[3] < 0) > 6:
        return None
    if any(w > IK.MAX_W_MEMBER or w % 1024
           for g in raw_groups for w in g[2]):
        return None
    slot_descs: list = []
    Ws: list[int] = []
    groups: list[tuple] = []
    for fl, sl, wl, src in raw_groups:
        idxs = tuple(range(len(slot_descs), len(slot_descs) + len(sl)))
        groups.append((fl, idxs, src))
        slot_descs += sl
        Ws += wl
    # the pivot group's windows bound the per-phase scratch; member
    # windows are only searched — a rare pivot can intersect against an
    # ultra-common member term without falling back
    req = [(i, sum(Ws[j] for j in g[1]))
           for i, g in enumerate(groups)
           if g[0] == IK.REQ and g[2] < 0
           and all(Ws[j] <= IK.MAX_W_PIVOT for j in g[1])]
    if not req:
        return None
    pivot_g = min(req, key=lambda e: e[1])[0]
    if len(groups[pivot_g][1]) > 4:
        return None
    # the JAX kernel's on-chip window budget, kept so that both packages
    # route the same queries to the kernel: 3 window arrays per text slot
    # (+doclens per pivot slot), 2 per tag slot, dense code windows per
    # (pred, pivot slot), plus 3 pivot-sized state buffers
    pivs = set(groups[pivot_g][1])
    srcs = IK._slot_srcs(len(slot_descs), groups)
    vmem = sum(((4 if j in pivs else 3) if srcs[j] < 0 else 2)
               * (Ws[j] + 1024) * 4
               for j in range(len(Ws)))
    vmem += 3 * (max(Ws[j] for j in pivs) + 1024) * 4
    vmem += len(dense_descs) * sum((Ws[j] + 1024) * 4 for j in pivs)
    if vmem > 12 * 1024 * 1024:
        return None
    aux_keys = tuple(f"tag{o}_docs" for o in aux_ords) + tuple(
        f"tag{o}_pcodes" for (_fl, o, _nv, _idx) in dense_descs)
    kdense = tuple((fl, len(aux_ords) + di, nv)
                   for di, (fl, _o, nv, _idx) in enumerate(dense_descs))
    dmeta = tuple((o, nv, idx) for (_fl, o, nv, idx) in dense_descs)
    return (tuple(slot_descs), tuple(Ws), tuple(groups), pivot_g,
            aux_keys, kdense, dmeta)


def _kernel_seg_ok(cq0: CompiledQuery, seg: Segment, k_pad: int) -> bool:
    """Shared cleanliness preconditions for the term kernels."""
    opts = cq0.opts
    if (opts.scorer != "BM25STD" or opts.sort_field is not None
            or cq0.knn is not None or k_pad > 64):
        return False
    if (seg.n_deleted > 0 or seg.has_ttl or seg.text_fexp is not None
            or not seg.uniform_docscore or seg.field_fexp):
        return False
    # kernel member hits derive from (weighted tf sum > 0); a WEIGHT 0
    # TEXT field stores tf == 0.0 postings, which would silently drop
    # REQ matches / miss NOT exclusions in the JAX package's kernel —
    # both packages keep such schemas off the kernel path
    for f in cq0.schema.fields:
        if f.type == FieldType.TEXT and f.weight <= 0:
            return False
    try:
        if seg.text.field_masks.ndim != 1:
            return False
    except Exception:
        return False
    return True


def _kernel_plan_phrase(cq0: CompiledQuery, seg: Segment, bk: dict,
                        k_pad: int):
    """Eligibility for the phrase kernel (ops/intersect.py phrase_batch):
    a single exact / in-order-slop phrase leaf on a clean segment, with
    in-window (non-overflow) position lists.  Returns (slots, Ws, PWs,
    stride, slop) or None.  A copy of the JAX planner's, gates and budget
    included, so that both packages route the same phrases to the kernel;
    only its RS_TPU_NO_INTERSECT_KERNEL switch is left out, as in
    `_kernel_plan`."""
    if not _kernel_seg_ok(cq0, seg, k_pad):
        return None
    tree = cq0.tree
    if tree[0] != "leaf" or not isinstance(tree[1], LPhrase):
        return None
    leaf = tree[1]
    if not leaf.inorder or leaf.slop < 0:
        return None
    T = len(leaf.slots)
    if not 2 <= T <= 4:
        return None
    if tuple(leaf.slots) != tuple(range(leaf.score_lo, leaf.score_hi)):
        return None
    e = bk.get(tree[2])
    if not e:
        return None
    Wn, Pc, Pm, pivot_j, bigs, _big_rounds, n_chunks = e
    if n_chunks > 1 or any(bigs) or pivot_j != 0:
        return None
    if Wn > IK.MAX_W_MEMBER or Wn % 1024:
        return None
    if Pc > IK.MAX_W_MEMBER or Pc % 1024 or Pm > IK.MAX_W_MEMBER \
            or Pm % 1024:
        return None
    try:
        if seg.text.poskeys.shape[0] % 128:
            return None
    except Exception:
        return None
    Ws = (Wn,) * T
    PWs = (Pc,) + (Pm,) * (T - 1)
    # VMEM budget: posting windows (slot0 carries doclens), poskey
    # windows, 6 chain buffers (Pc), 3 fold/score buffers (W0)
    vmem = sum((4 if t == 0 else 3) * (Ws[t] + 1024) * 4
               for t in range(T))
    vmem += sum((PWs[t] + 1024) * 4 for t in range(T))
    vmem += 6 * (Pc + 1024) * 4
    vmem += 3 * (Wn + 1024) * 4
    if vmem > 12 * 1024 * 1024:
        return None
    return (tuple(leaf.slots), Ws, PWs, int(seg.text.pos_stride),
            max(int(leaf.slop), 0))


def _layout_of(proto: dict) -> tuple[list, int]:
    """Canonical flat int32 transport layout for a dict of arrays:
    sorted keys, each flattened to `size` lanes.  Shared by the packed
    executors and the per-query row cache (bind_row) — both sides must
    agree on it byte-for-byte."""
    layout = []
    off = 0
    for key in sorted(proto):
        a = np.asarray(proto[key])
        n = int(a.size) if a.shape else 1
        layout.append((key, off, n, a.shape, str(a.dtype)))
        off += n
    return layout, off


def _pack_into(layout: list, dyn: dict, buf: np.ndarray) -> np.ndarray:
    """Host-side pack by layout: floats ride as raw bit patterns (int32
    bitcast), so no device-side conversion can alter them."""
    for key, o, n, shape, dt in layout:
        if not n:
            continue
        a = np.asarray(dyn[key])
        if dt.startswith("float") or dt == "bfloat16":
            v = a.reshape(-1).astype(np.float32).view(np.int32)
        elif dt == "int32":
            v = a.reshape(-1)
        else:
            v = a.reshape(-1).astype(np.int32)
        buf[o:o + n] = v
    return buf


# Scorers whose final score divides by the proximity "slop" of the match
# (reference: ext/default.c tfIdfInternal:131 and BM25Scorer:226 both call
# ctx->GetSlop = IndexResult_MinOffsetDelta; BM25STD/DISMAX do not).
_SLOP_SCORERS = ("TFIDF", "TFIDF.DOCNORM", "BM25")


def _tree_term_slots(t) -> tuple:
    """All term slots under a subtree, in query order (the offset sources
    of the subtree's index result — reference: an aggregate result's
    offset iterator merges its term children's offset vectors)."""
    tag = t[0]
    if tag == "leaf":
        if isinstance(t[1], LTerms):
            return tuple(range(t[1].lo, t[1].hi))
        if isinstance(t[1], LPhrase):
            return tuple(t[1].slots)
        return ()
    if tag in ("not",):
        return ()       # NOT children contribute no offsets to the match
    if tag == "opt":
        return _tree_term_slots(t[1])
    out: list[int] = []
    for c in t[1]:
        out.extend(_tree_term_slots(c))
    return tuple(out)


def _slop_root_children(tree):
    """Root-result children for the GetSlop divisor (reference:
    IndexResult_MinOffsetDelta walks the ROOT aggregate's children,
    src/index_result/index_result.c:51; ext/default.c:131,226).

    Returns None when the root is not an aggregate (slop = 1), else
    (mode, children): mode "and" = every child matched each candidate
    (intersection), "or" = presence varies per doc (union).  Each child is
    ("slots", slot_tuple, subtree_or_None) for offset-bearing children or
    ("pred", subtree) for children without offsets (numeric/tag/geo —
    counted in the child total, skipped for deltas)."""
    tag = tree[0]
    if tag == "leaf" and isinstance(tree[1], LPhrase):
        slots = tuple(tree[1].slots)
        if len(slots) < 2:
            return None
        return ("and", [("slots", (s,), None) for s in slots])
    if tag == "leaf" and isinstance(tree[1], LTerms):
        # a stem/synonym-expanded token lowers to one LTerms group, but the
        # reference models it as a UNION of term children
        slots = tuple(range(tree[1].lo, tree[1].hi))
        if len(slots) < 2:
            return None
        return ("or", [("slots", (s,), None) for s in slots])
    if tag in ("and", "or", "dismax"):
        kids = tree[1]
        if len(kids) < 2:
            return None
        children = []
        for c in kids:
            slots = _tree_term_slots(c)
            if slots:
                children.append(("slots", slots, c))
            else:
                children.append(("pred", c))
        return ("and" if tag == "and" else "or", children)
    return None


def decode_blob(raw, field) -> np.ndarray:
    """Vector query payloads: not ported yet.  (The JAX version decodes
    bf16 blobs through `ml_dtypes`, which the port must not need.)"""
    raise NotImplementedError(
        f"vector queries (@{field.name}) are not ported yet (ROADMAP A7)")


# ---------------------------------------------------------------------------
# Executor: the kernel branch of the JAX executor
# ---------------------------------------------------------------------------

#: how many batched queries rode which executor family (callers reset it)
QUERY_PATH_STATS: dict[str, int] = {"kernel": 0, "phrase-kernel": 0}


@dataclasses.dataclass
class SegmentResult:
    """One query's outputs for one segment, on the host."""
    local_idx: np.ndarray      # int32[k]
    scores: np.ndarray         # float32[k] (NEG_INF for an empty tail)
    count: int                 # total matching docs


class _BatchHandle:
    """A launched batch: each group's outputs are device tensors that
    may still be in flight; result() copies them to the host (one copy
    per output column per group) and builds the per-query results."""

    def __init__(self, parts, n: int):
        self._parts = parts      # [(query indices, output tensors)]
        self._n = n

    def result(self) -> list:
        out_all: list = [None] * self._n
        for idxs, out in self._parts:
            host = {kk: vv.cpu().numpy() for kk, vv in out.items()}
            for j, slot in enumerate(idxs):
                out_all[slot] = SegmentResult(
                    local_idx=host["idx"][j], scores=host["scores"][j],
                    count=int(host["count"][j]))
        return out_all


def execute_batch(cqs: list, seg: Segment, k: int, async_: bool = False):
    """Run a batch of queries: every group of queries sharing a (tree
    structure, window buckets) signature is one kernel launch over its
    stacked transport rows; all groups launch before any is collected.
    Returns one SegmentResult per query; with async_=True, the
    `_BatchHandle` at once (the card may still be working), whose
    result() collects."""
    parts = [(idxs, entry.run(seg_args, rows))
             for idxs, entry, seg_args, rows in _prep_subs(cqs, seg, k)]
    handle = _BatchHandle(parts, len(cqs))
    return handle if async_ else handle.result()


def _prep_subs(cqs: list, seg: Segment, k: int) -> list:
    """Bind + group + stack a batch: [(query indices, executor,
    segment args, stacked rows)].

    Every query binds as a packed transport row (memoized per segment),
    then groups by group_sig (tree structure + window buckets) and the
    layout fingerprint: the group's rows are patched at offsets taken
    from its first query's layout."""
    groups: dict[tuple, list[int]] = {}
    ents = []
    for i, cq in enumerate(cqs):
        ent = cq._row_cache.get(seg.uid)
        if ent is None:
            _, ent = cq.bind_row(seg)
        ents.append(ent)
        groups.setdefault((ent[6], ent[7]), []).append(i)
    subs = []
    for idxs in groups.values():
        gr = np.stack([ents[i][0] for i in idxs])
        for key, o, _n, _shape, _dt in ents[idxs[0]][1]:
            if key != "now":
                raise NotImplementedError(
                    f"per-call payload {key!r} (vector queries) is not "
                    "ported yet (ROADMAP A7)")
            gr[:, o] = np.fromiter((cqs[i].opts.now for i in idxs),
                                   np.int32, len(idxs))
        entry = _rows_executor(cqs[idxs[0]], ents[idxs[0]], seg, k)
        QUERY_PATH_STATS[entry.path] = (
            QUERY_PATH_STATS.get(entry.path, 0) + len(idxs))
        subs.append((idxs, entry, _segment_args(cqs[idxs[0]], seg), gr))
    return subs


class _KernelExecutor:
    """One batch group on the intersection kernel (the JAX executor's
    kernel branch, `_rows_executor` with `_kernel_plan` set)."""

    path = "kernel"

    def __init__(self, layout: list, kplan: tuple, k_pad: int, ke: int):
        self.layout = layout
        (self.descs, self.Ws, self.groups, self.pivot_g, self.aux_keys,
         self.dense, self.dmeta) = kplan
        self.k_pad = k_pad
        self.ke = ke

    def run(self, seg_args: dict, rows_np: np.ndarray) -> dict:
        """Upload the group's [B, total] rows once, unpack them on the
        device, launch the kernel, merge the phases.  Returns device
        tensors {"idx" [B, ke], "scores" [B, ke], "count" [B]}."""
        rows = torch.from_numpy(rows_np).to(seg_args["doc_ids"].device)
        stacked = _device_unpack_rows(self.layout, rows)
        meta, fmeta, aux_arrs = _kernel_batched_inputs(
            stacked, seg_args, self.descs, self.aux_keys, self.dmeta)
        docs, scores, count = IK.intersect_batch(
            meta, fmeta, seg_args["doc_ids"], seg_args["freqs"],
            seg_args["field_masks"], seg_args["posting_dl"], *aux_arrs,
            T=len(self.descs), Ws=self.Ws, groups=self.groups,
            pivot_g=self.pivot_g, k=self.k_pad, dense=self.dense)
        ke = self.ke
        if len(self.groups[self.pivot_g][1]) == 1:
            # one phase: the kernel's lanes are already the exact top-k
            return {"idx": docs[:, :ke], "scores": scores[:, :ke],
                    "count": count}
        # per-phase top-k lanes merge by score, lowest lane on ties;
        # exhausted lanes keep the INT32_MAX doc filler
        vals, sel = IK.iter_topk(scores, docs, ke)
        idx = torch.gather(docs, 1, sel)
        idx = torch.where(vals > -3e38, idx, IK.INT32_MAX)
        return {"idx": idx, "scores": vals, "count": count}


class _PhraseExecutor:
    """One batch group on the phrase kernel (the JAX executor's phrase
    branch, `_rows_executor` with `_kernel_plan_phrase` set)."""

    path = "phrase-kernel"

    def __init__(self, layout: list, pplan: tuple, k_pad: int, ke: int):
        self.layout = layout
        self.slots, self.Ws, self.PWs, self.stride, self.slop = pplan
        self.k_pad = k_pad
        self.ke = ke

    def inputs(self, seg_args: dict, rows_np: np.ndarray) -> tuple:
        """(meta, fmeta) of the group: one upload of the [B, total] rows,
        unpacked on the device, the phrase slots' posting windows and
        their poskey windows through `pos_offsets`."""
        rows = torch.from_numpy(rows_np).to(seg_args["doc_ids"].device)
        stacked = _device_unpack_rows(self.layout, rows)
        sl = list(self.slots)
        ts = stacked["tstarts"][:, sl].to(torch.int32)
        tl = stacked["tlens"][:, sl].to(torch.int32)
        tm = stacked["tmasks"][:, sl].to(torch.int32)
        po = seg_args["pos_offsets"]
        pstart = po[ts.long()]
        plen = po[(ts + tl).long()] - pstart
        meta = torch.cat([ts, tl, tm, pstart, plen], dim=1)
        fmeta = torch.cat([stacked["tweight"][:, sl],
                           stacked["avgdl"].reshape(-1, 1)], dim=1)
        return (meta.to(torch.int32).contiguous(),
                fmeta.to(torch.float32).contiguous())

    def raw(self, dev: torch.device) -> bool:
        """The JAX package's raw gate for small term-0 windows, with
        "the tensors are on the card" in place of `_use_pallas()`: the
        kernel then skips its arg-max passes and `iter_topk` merges."""
        return ((self.Ws[0] // 128 + IK.R_EXTRA) * 128 <= 10_240
                and dev.type == "cuda")

    def run(self, seg_args: dict, rows_np: np.ndarray) -> dict:
        """Launch the kernel for the group and take each query's top
        lanes.  Returns device tensors {"idx" [B, ke], "scores" [B, ke],
        "count" [B]}."""
        meta, fmeta = self.inputs(seg_args, rows_np)
        docs, scores, count = IK.phrase_batch(
            meta, fmeta, seg_args["doc_ids"], seg_args["freqs"],
            seg_args["field_masks"], seg_args["posting_dl"],
            seg_args["poskeys"], T=len(self.slots), Ws=self.Ws,
            PWs=self.PWs, stride=self.stride, slop=self.slop, k=self.k_pad,
            raw=self.raw(meta.device))
        vals, sel = IK.iter_topk(scores, docs, self.ke)
        idx = torch.gather(docs, 1, sel)
        # exhausted lanes keep the INT32_MAX doc filler
        idx = torch.where(vals > -3e38, idx, IK.INT32_MAX)
        return {"idx": idx, "scores": vals, "count": count}


def _rows_executor(cq0: CompiledQuery, ent: tuple, seg: Segment, k: int):
    """The executor of one batch group: the intersection kernel, else
    the phrase kernel; groups neither serves raise instead of falling
    back."""
    _static, _patches, layout, _total, bk, _P2, _gsig, _lfp = ent
    k_pad = int(min(next_pow2(max(k, 1)), seg.n_pad))
    kplan = _kernel_plan(cq0, seg, bk, k_pad)
    if kplan is not None:
        return _KernelExecutor(layout, kplan, k_pad, min(k, k_pad))
    pplan = _kernel_plan_phrase(cq0, seg, bk, k_pad)
    if pplan is not None:
        return _PhraseExecutor(layout, pplan, k_pad, min(k, k_pad))
    what = ("phrases outside the phrase kernel's shapes (unordered slop, "
            "more than 4 terms, ultra-common terms)"
            if cq0._phrase_leaves(cq0.tree)
            else "queries outside the intersection kernel's shapes")
    raise NotImplementedError(
        f"not ported yet: {what} — the general window path (ROADMAP A6)")


def _kernel_batched_inputs(stacked, seg_args_, descs, aux_keys, dmeta):
    """The kernel's per-query inputs from the unpacked rows: per-slot
    (starts, lens, qmasks) + dense value ids as int32 meta, (tweights,
    avgdl, dense consts) as f32 meta, plus the aux window arrays."""
    cs, cl, cm, cw = [], [], [], []
    for d in descs:
        if d[0] == "t":
            s = d[1]
            cs.append(stacked["tstarts"][:, s])
            cl.append(stacked["tlens"][:, s])
            cm.append(stacked["tmasks"][:, s])
            cw.append(stacked["tweight"][:, s])
        else:               # ("g", tag_ord, value_j, leaf_idx)
            _g, ordn, j, lidx = d
            cs.append(stacked[f"tag{ordn}_starts"][:, j])
            cl.append(stacked[f"tag{ordn}_lens"][:, j])
            cm.append(torch.zeros_like(cs[-1]))
            cw.append(stacked["leaf_const"][:, lidx])
    meta = torch.stack(cs + cl + cm, dim=1).to(torch.int32)
    qcols = [stacked[f"tag{o}_qcodes"][:, :nv].to(torch.int32)
             for (o, nv, _lidx) in dmeta]
    if qcols:
        meta = torch.cat([meta] + qcols, dim=1)
    fmeta = torch.stack(
        cw + [stacked["avgdl"].reshape(-1)]
        + [stacked["leaf_const"][:, lidx] for (_o, _nv, lidx) in dmeta],
        dim=1).to(torch.float32)
    aux_arrs = tuple(seg_args_[kk] for kk in aux_keys)
    return meta.contiguous(), fmeta.contiguous(), aux_arrs


def _device_unpack_rows(layout: list, rows: torch.Tensor) -> dict:
    """Unpack [B, total] int32 transport rows on their device into a dict
    of [B, ...] tensors, one slice per key; floats travel as bit
    patterns and are reinterpreted with `.view(torch.float32)`."""
    B = rows.shape[0]
    d = {}
    for key, o, n, shape, dt in layout:
        if shape and int(np.prod(shape)) == 0:
            d[key] = torch.zeros((B,) + tuple(shape),
                                 dtype=getattr(torch, dt), device=rows.device)
            continue
        sl = rows[:, o:o + n]
        if dt.startswith("float") or dt == "bfloat16":
            sl = sl.contiguous().view(torch.float32)
            if dt != "float32":
                sl = sl.to(getattr(torch, dt))
        elif dt == "bool":
            sl = sl != 0
        elif dt != "int32":
            sl = sl.to(getattr(torch, dt))
        d[key] = sl.reshape((B,) + tuple(shape)) if shape else sl[:, 0]
    return d


def _segment_args(cq: CompiledQuery, seg: Segment) -> dict:
    """The device arrays the kernels read: text postings and position
    keys, and per TAG leaf its doc postings and posting-aligned codes."""
    args = {
        "doc_ids": seg.text.doc_ids,
        "freqs": seg.text.freqs,
        "field_masks": seg.text.field_masks,
        "posting_dl": seg.text.doclens,
        "pos_offsets": seg.text.pos_offsets,
        "poskeys": seg.text.poskeys,
    }
    for j, node in enumerate(cq.tag_nodes):
        attr = cq.schema.field(node.field).attribute
        tp = seg.tags.get(attr)
        args[f"tag{j}_docs"] = (
            tp.doc_ids if tp is not None
            else torch.zeros(1, dtype=torch.int32, device=seg.device))
        if tp is not None and tp.codes is not None:
            pc = seg.tag_pcodes(attr)
            if pc is not None:
                args[f"tag{j}_pcodes"] = pc
    return args

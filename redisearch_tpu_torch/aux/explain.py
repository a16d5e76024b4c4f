# Copy of redisearch_tpu/aux/explain.py: the port imports nothing of the JAX package.
"""Score explanation (EXPLAINSCORE) and per-node query profiling
(FT.PROFILE iterator counters).

Reference: EXPLAINSCORE builds a score-explanation tree during scoring
(src/ext/default.c scorers with EXPLAIN, src/score_explain.c); FT.PROFILE
wraps every iterator with counters (Profile_AddIters, rqe_iterators/src/
profile.rs).

The TPU engine scores entire windows in one program, so explanations are
*reconstructed* per returned document (exact same formulas over the same
stored values), and profile counters come from evaluating each AST node as
its own counting sub-query — semantically the per-iterator counts the
reference reports, collected batch-at-a-time.

In the port a segment's arrays are torch tensors on its device (host
numpy on a cold segment): a posting window is read with one copy
(`_host`), the doc length from the `doclen_np` mirror, and the profile's
timed pass ends in a `torch.cuda.synchronize` on a card.
"""

from __future__ import annotations

import time
from typing import Any, Optional

import numpy as np
import torch

from ..ops.text import BM25_B, BM25_K1
from ..query import ast
from ..query.engine import CompiledQuery, QueryOptions, execute


def _host(x) -> np.ndarray:
    """A window of a segment array as host numpy: one copy of a tensor
    slice (never element by element), or the cold segment's own numpy."""
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


def explain_score(index, query: str, key: str,
                  params: Optional[dict] = None,
                  scorer: str = "BM25STD") -> dict:
    """Explain the score of one document for a query.

    Returns a tree: {"value": v, "description": ..., "children": [...]}
    mirroring the reference's EXPLAINSCORE reply shape.
    """
    index.commit()
    meta = index.doctable.get_by_key(key)
    if meta is None:
        return {"value": 0.0, "description": "document not found",
                "children": []}
    root = index.parse_query(query, params)
    opts = QueryOptions(scorer=scorer)
    cq = index.compile(root, opts)

    seg = None
    local = None
    for s in index.segments:
        loc = s.gid_to_local.get(meta.gid)
        if loc is not None:
            seg = s
            local = loc
            break
    if seg is None:
        return {"value": 0.0, "description": "document not indexed",
                "children": []}

    binding, _P = cq.bind(seg)
    dyn = binding.dyn
    starts = dyn["tstarts"]
    lens = dyn["tlens"]
    tweight = dyn["tweight"]
    avgdl = float(dyn["avgdl"])
    doclen = float(seg.doclen_np[local])
    maxfreq = float(seg.max_freq[local])
    docscore = float(seg.docscore[local])

    term_strings = list(cq.term_strings)

    def slot_explain(slot: int) -> dict:
        term = term_strings[slot]
        length = int(lens[slot])
        if length == 0:
            return {"value": 0.0,
                    "description": f"term '{term}' not in index",
                    "children": []}
        a = int(starts[slot])
        docs = _host(seg.text.doc_ids[a:a + length])
        pos = int(np.searchsorted(docs, local))
        if pos >= length or docs[pos] != local:
            return {"value": 0.0,
                    "description": f"term '{term}' not in doc", "children":
                    []}
        tf = float(seg.text.freqs[a + pos])
        w = float(tweight[slot])
        if scorer == "BM25":
            # legacy BM25 (ext/default.c bm25Recursive): k1=1.2, b=0.5,
            # denominator uses only avgdl; w carries the logb idf
            norm = 1.2 * (1 - 0.5 + 0.5 * avgdl)
            v = w * tf / (tf + norm)
            desc = (f"'{term}': idf*w {w:.4f} * tf {tf:.1f} "
                    f"/ (tf + k1*(1-b+b*avgdl) {norm:.4f})")
        elif scorer.startswith("BM25"):
            norm = BM25_K1 * (1 - BM25_B + BM25_B * doclen
                              / max(avgdl, 1e-9))
            v = w * tf * (BM25_K1 + 1.0) / (tf + norm)
            desc = (f"'{term}': idf*w {w:.4f} * tf {tf:.1f} * (k1+1) "
                    f"/ (tf + k1*(1-b+b*dl/avgdl) {norm:.4f})")
        elif scorer == "TFIDF.DOCNORM":
            v = w * tf / max(doclen, 1.0)
            desc = f"'{term}': idf*w {w:.4f} * tf {tf:.1f} / dl {doclen:.0f}"
        else:
            v = w * tf / max(maxfreq, 1.0)
            desc = (f"'{term}': idf*w {w:.4f} * tf {tf:.1f} "
                    f"/ maxFreq {maxfreq:.0f}")
        return {"value": v, "description": desc, "children": []}

    def explain_tree(t) -> dict:
        tag = t[0]
        if tag == "leaf":
            leaf = t[1]
            name = type(leaf).__name__
            if name == "LTerms":
                kids = [slot_explain(s) for s in range(leaf.lo, leaf.hi)
                        if term_strings[s]]
                v = sum(k["value"] for k in kids)
                return {"value": v, "description": "term union (sum)",
                        "children": kids}
            if name == "LPhrase":
                kids = [slot_explain(s)
                        for s in range(leaf.score_lo, leaf.score_hi)]
                v = sum(k["value"] for k in kids)
                return {"value": v, "description":
                        f"phrase slop={leaf.slop}", "children": kids}
            return {"value": float(cq.leaf_consts[t[2]]),
                    "description": name.lower().lstrip("l") + " filter",
                    "children": []}
        if tag == "and":
            kids = [explain_tree(c) for c in t[1]]
            return {"value": sum(k["value"] for k in kids),
                    "description": "intersection (sum of children)",
                    "children": kids}
        if tag in ("or", "dismax"):
            kids = [explain_tree(c) for c in t[1]]
            if tag == "dismax":
                v = max((k["value"] for k in kids), default=0.0)
                return {"value": v, "description": "dismax (max)",
                        "children": kids}
            return {"value": sum(k["value"] for k in kids),
                    "description": "union (sum)", "children": kids}
        if tag == "not":
            return {"value": 0.0, "description": "not", "children": []}
        if tag == "opt":
            k = explain_tree(t[1])
            return {"value": k["value"], "description": "optional",
                    "children": [k]}
        return {"value": 0.0, "description": tag, "children": []}

    def slot_positions(slot: int) -> list[int]:
        length = int(lens[slot])
        if length == 0:
            return []
        a = int(starts[slot])
        docs = _host(seg.text.doc_ids[a:a + length])
        pos = int(np.searchsorted(docs, local))
        if pos >= length or docs[pos] != local:
            return []
        po = seg.text.pos_offsets_np
        ks = _host(seg.text.poskeys[int(po[a + pos]):
                                    int(po[a + pos + 1])])
        stride = seg.text.pos_stride
        return sorted(int(k) - local * stride for k in ks)

    def get_slop() -> int:
        """Host reconstruction of the GetSlop divisor (reference:
        IndexResult_MinOffsetDelta, index_result.c:51)."""
        from ..query.engine import _slop_root_children
        info = _slop_root_children(cq.tree)
        if info is None:
            return 1
        mode, childs = info
        plists = []
        for ch in childs:
            if ch[0] != "slots":
                plists.append(None)   # no offsets; counted in num
                continue
            merged: list[int] = []
            for s in ch[1]:
                merged.extend(slot_positions(s))
            plists.append(sorted(merged))
        present = [pl is None or len(pl) > 0 for pl in plists]
        if mode == "and":
            present = [True] * len(childs)
        num = sum(present)
        if num <= 1:
            return 1
        offs = [pl for pl, p in zip(plists, present)
                if pl is not None and p and pl]
        dist = 0
        for va, vb in zip(offs, offs[1:]):
            cd = min((abs(a - b) for a in va for b in vb), default=0)
            dist += cd * cd
        return int(dist ** 0.5) if dist else max(num - 1, 1)

    tree = explain_tree(cq.tree)
    final = tree["value"] * docscore
    desc = (f"final: tree {tree['value']:.4f} * docscore "
            f"{docscore:.2f}")
    if scorer in ("TFIDF", "TFIDF.DOCNORM", "BM25"):
        slop = get_slop()
        if slop > 1:
            final = final / slop
            desc += f" / slop {slop}"
    if scorer == "BM25STD.TANH":
        final = float(np.tanh(final))
    if scorer == "DOCSCORE":
        final = docscore
    return {"value": final,
            "description": desc,
            "children": [tree]}


def profile_query(index, query: str, params: Optional[dict] = None,
                  **opts_kw) -> dict:
    """Per-node match counters + MEASURED timings (FT.PROFILE iterator
    section — reference: Profile_AddIters wraps every iterator with
    counters/timers, rqe_iterators/src/profile.rs).

    Counters come from executing each AST node as its own counting
    sub-query — i.e. from the executed program's outputs, not a host
    estimate.  Timings are measured on a SECOND, warm execution (the
    first one may pay a kernel build, which the reference's clocks also
    exclude from per-iterator time), ended by a synchronize of the
    index's card, so no work still queued there falls outside the
    clock.
    The root node's time is the real full-tree evaluation time."""
    index.commit()
    root = index.parse_query(query, params)

    def run_node(node: ast.Node):
        """(count, warm_ms) for one subtree, or (-1, 0) if unevaluable."""
        try:
            cq = index.compile(node, QueryOptions())
            total = 0
            for seg in index.segments:      # warm pass (count + compile)
                total += execute(cq, seg, 1, mode="window").count
            t0 = time.perf_counter()
            for seg in index.segments:      # measured warm pass
                execute(cq, seg, 1, mode="window")
            if index.device.type == "cuda":
                torch.cuda.synchronize(index.device)
            ms = (time.perf_counter() - t0) * 1e3
            return total, ms
        except Exception:
            return -1, 0.0

    def walk(node: ast.Node) -> dict:
        cnt, ms = run_node(node)
        entry = {
            "type": type(node).__name__.replace("Node", ""),
            "counter": cnt,
            "time_ms": round(ms, 3),
        }
        if isinstance(node, ast.TokenNode):
            entry["term"] = node.term
        kids = [walk(c) for c in node.children() if c is not None]
        if kids:
            entry["children"] = kids
        return entry

    return walk(root)

"""The plain reference: RediSearch's semantics for the query forms the
mixes send, computed again from the benchmark's own arrays (`Dataset`).

It imports nothing of the program.  Filters are evaluated on the drawn
tag and numeric columns, distances on the drawn vectors in float64, text
on postings built from the drawn tokens (`bm25.py`).  A KNN query's
answer is the k documents that pass its filter nearest the query vector
by cosine distance (1 - cos), ties by ascending document id, the order
of the bulk load; its total is min(k, documents that pass).  Any other
query's answer is the k documents that match it with the highest
BM25STD scores (`bm25.py` gives the formulas and how a query's clauses
combine them), ties by ascending document id; its total is the number
of documents that match.

`Reference(ds, precision="bfloat16")` is the control: for KNN the same
computation with the vectors and the query in bfloat16, summed in
float32 and the distance rounded to bfloat16 (the precision below the
configuration's float32); for text the float64 scores rounded to
bfloat16 and ranked so.  It is put in the program's place to show that
the comparison fails it.

The query forms: bare terms (all TEXT fields), `@text:term` and
`@text:(...)`, exact phrases `"a b"`, `@tag:{a|b}`, `@num:[lo hi]`
(inclusive), `*`, sequences (AND), `-not`, `~optional`, `a | b` (OR)
and parentheses, then a trailing `=>[KNN k @vec $param]`.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from .bm25 import TextIndex

_WORD = re.compile(r"\w+")


# ---------------------------------------------------------------- parsing
def parse(q: str):
    """(query node, (k, vector field, param) or None)."""
    q = q.strip()
    knn = None
    i = q.find("=>[")
    if i >= 0:
        inner = q[i + 3:q.rindex("]")].split()
        if inner[0].upper() != "KNN":
            raise ValueError(f"unsupported vector clause in {q!r}")
        knn = (int(inner[1]), inner[2].lstrip("@"), inner[3].lstrip("$"))
        q = q[:i].strip()
    if q in ("", "*", "(*)"):
        return ("all",), knn
    p = _Parser(q)
    node = p.seq(None)
    if p.i != len(q):
        raise ValueError(f"cannot parse {q!r} at {p.i}")
    return node, knn


class _Parser:
    def __init__(self, s: str):
        self.s, self.i = s, 0

    def peek(self):
        while self.i < len(self.s) and self.s[self.i] == " ":
            self.i += 1
        return self.s[self.i] if self.i < len(self.s) else None

    def seq(self, close, fields=None):
        """OR of AND sequences: `|` binds loosest.  `fields`: the TEXT
        fields an enclosing `@F:` scopes terms to (None: all)."""
        alts = [self.conj(close, fields)]
        while self.peek() == "|":
            self.i += 1
            alts.append(self.conj(close, fields))
        return alts[0] if len(alts) == 1 else ("or", alts)

    def conj(self, close, fields):
        items = []
        while self.peek() not in (None, close, "|"):
            c = self.peek()
            if c in "-~":
                self.i += 1
                items.append(("not" if c == "-" else "opt",
                              self.atom(fields)))
            else:
                items.append(self.atom(fields))
        return items[0] if len(items) == 1 else ("and", items)

    def until(self, ch):
        j = self.s.index(ch, self.i)
        out, self.i = self.s[self.i:j], j + 1
        return out

    def word(self) -> str:
        m = _WORD.match(self.s, self.i)
        if m is None:
            raise ValueError(f"unsupported {self.s[self.i]!r} in {self.s!r}")
        self.i = m.end()
        return m.group().lower()

    def atom(self, fields):
        c = self.peek()
        if c == "(":
            self.i += 1
            node = self.seq(")", fields)
            self.i += 1
            return node
        if c == "*":
            self.i += 1
            return ("all",)
        if c == '"':
            self.i += 1
            words = self.until('"').split()
            if fields is not None:
                raise ValueError(f"unsupported scoped phrase in {self.s!r}")
            return ("phrase", [w.lower() for w in words])
        if c != "@":
            return ("term", fields, self.word())
        self.i += 1
        fld = self.until(":")
        c2 = self.s[self.i]
        if c2 == "{":
            self.i += 1
            return ("tag", fld, [v.strip().lower()
                                 for v in self.until("}").split("|")])
        if c2 == "[":
            self.i += 1
            lo, hi = self.until("]").split()
            return ("num", fld, float(lo), float(hi))
        return self.atom((fld,))


# -------------------------------------------------------------- reference
def _at(rows: np.ndarray, values: np.ndarray, want: np.ndarray
        ) -> np.ndarray:
    """`values` of ascending `rows` at the rows `want`, 0 where absent."""
    at = np.searchsorted(rows, want)
    hit = at < len(rows)
    hit[hit] = rows[at[hit]] == want[hit]
    out = np.zeros(len(want))
    out[hit] = values[at[hit]]
    return out


class Reference:
    """The reference over a `Dataset`, in float64 or, for the control,
    in bfloat16."""

    def __init__(self, ds, precision: str = "float64"):
        self.ds = ds
        self.prec = precision
        self.n_live = ds.n
        self._row_of_key = None
        self._vec = {}
        self._text = None

    @property
    def text(self) -> TextIndex:
        """The TEXT fields' postings and scores, built at first use."""
        if self._text is None:
            self._text = TextIndex(self.ds)
        return self._text

    def eval(self, node) -> np.ndarray:
        """The rows (ascending) that match a node."""
        return self.scored(node)[0]

    def scored(self, node) -> tuple:
        """(rows ascending, float64 score at each) of a node."""
        kind = node[0]
        if kind == "term":
            return self.text.scoped(node[2], node[1])
        if kind == "phrase":
            return self.text.phrase(node[1])
        if kind == "and":
            return self._and(node[1])
        if kind in ("not", "opt"):
            return self._and([node])
        if kind == "or":
            parts = [self.scored(c) for c in node[1]]
            rows, inv = np.unique(np.concatenate([r for r, _ in parts]),
                                  return_inverse=True)
            return rows, np.bincount(inv, weights=np.concatenate(
                [s for _, s in parts]), minlength=len(rows))
        rows = self._filter(node)
        return rows, np.ones(len(rows))

    def _filter(self, node) -> np.ndarray:
        kind = node[0]
        if kind == "all":
            return np.arange(self.ds.n)
        if kind == "tag":
            vals = [v.lower() for v in self.ds.tag_values(node[1])]
            codes = [vals.index(v) for v in node[2] if v in vals]
            return np.flatnonzero(np.isin(self.ds.tags[node[1]], codes))
        if kind == "num":
            x = self.ds.numeric[node[1]]
            return np.flatnonzero((x >= node[2]) & (x <= node[3]))
        raise ValueError(f"unknown node {kind!r}")

    def _and(self, items: list) -> tuple:
        pos = [c for c in items if c[0] not in ("not", "opt")]
        rows, score = self.scored(pos[0] if pos else ("all",))
        for c in pos[1:]:
            r, s = self.scored(c)
            rows, a, b = np.intersect1d(rows, r, assume_unique=True,
                                        return_indices=True)
            score = score[a] + s[b]
        for c in items:
            if c[0] == "not":
                keep = ~np.isin(rows, self.scored(c[1])[0],
                                assume_unique=True)
                rows, score = rows[keep], score[keep]
            elif c[0] == "opt":
                score = score + _at(*self.scored(c[1]), rows)
        return rows, score

    def distances(self, field: str, q: np.ndarray, rows: np.ndarray
                  ) -> np.ndarray:
        """Cosine distance (1 - cos) from query vector q to `rows`: in
        float64, or for the control from bfloat16 operands summed in
        float32 and rounded to bfloat16."""
        v = self.ds.vectors[field]
        idx = torch.from_numpy(rows).to(v.device)
        if self.prec == "float64":
            if field not in self._vec:
                v64 = v.double()
                self._vec[field] = v64 / v64.norm(dim=1, keepdim=True)
            q64 = torch.from_numpy(np.asarray(q, np.float64)).to(v.device)
            d = 1.0 - (self._vec[field][idx] @ (q64 / q64.norm()))
            return d.cpu().numpy()
        if field not in self._vec:
            vb = v.to(torch.bfloat16).float()
            self._vec[field] = (vb, (vb ** 2).sum(1).sqrt())
        vb, nv = self._vec[field]
        qb = torch.from_numpy(np.asarray(q, np.float32)).to(v.device).to(
            torch.bfloat16).float()
        d = (1.0 - (vb[idx] @ qb) / (nv[idx] * (qb ** 2).sum().sqrt())).to(
            torch.bfloat16)
        return d.double().cpu().numpy()

    def key_row(self, key: str) -> int:
        """The row of a key (-1: none)."""
        if self._row_of_key is None:
            self._row_of_key = {k: r for r, k in enumerate(self.ds.keys)}
        return self._row_of_key.get(key, -1)

    def search(self, query: str, params: dict, k: int) -> dict:
        """A query's answer: its total, the ranked rows, the value of
        every row that matches (`rows`, `values`: a KNN query's
        distances, any other query's scores), and which way is `better`
        ("lower" or "higher")."""
        node, knn = parse(query)
        if knn is None:
            rows, s = self.scored(node)
            if self.prec != "float64":
                s = torch.from_numpy(s).to(torch.bfloat16).double().numpy()
            order = np.lexsort((rows, -s))
            return {"total": len(rows), "rows": rows, "values": s,
                    "ranked": rows[order[:k]], "better": "higher"}
        rows = self.eval(node)
        kk, field, param = knn
        d = self.distances(field, params[param], rows)
        order = np.lexsort((rows, d))
        return {"total": min(kk, len(rows)), "rows": rows, "values": d,
                "ranked": rows[order[:min(kk, k)]], "better": "lower"}

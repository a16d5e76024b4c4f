"""The plain reference: RediSearch's semantics for the query forms the
mixes send, computed again from the benchmark's own arrays (`Dataset`).

It imports nothing of the program.  Filters are evaluated on the drawn
tag and numeric columns, distances on the drawn vectors in float64.  A
KNN query's answer is the k documents that pass its filter nearest the
query vector by cosine distance (1 - cos), ties by ascending document
id, the order of the bulk load; its total is min(k, documents that
pass).

`Reference(ds, precision="bfloat16")` is the control: the same
computation with the vectors and the query in bfloat16, summed in
float32 and the distance rounded to bfloat16 (the precision below the
configuration's float32), put in the program's place to show that the
comparison fails it.

The query forms: `@tag:{a|b}`, `@num:[lo hi]` (inclusive), `*`,
sequences (AND), `-not`, `a | b` (OR) and parentheses, then a trailing
`=>[KNN k @vec $param]`.
"""

from __future__ import annotations

import numpy as np
import torch


# ---------------------------------------------------------------- parsing
def parse(q: str):
    """(filter node, (k, vector field, param) or None)."""
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

    def seq(self, close):
        """OR of AND sequences: `|` binds loosest."""
        alts = [self.conj(close)]
        while self.peek() == "|":
            self.i += 1
            alts.append(self.conj(close))
        return alts[0] if len(alts) == 1 else ("or", alts)

    def conj(self, close):
        items = []
        while self.peek() not in (None, close, "|"):
            if self.peek() == "-":
                self.i += 1
                items.append(("not", self.atom()))
            else:
                items.append(self.atom())
        return items[0] if len(items) == 1 else ("and", items)

    def until(self, ch):
        j = self.s.index(ch, self.i)
        out, self.i = self.s[self.i:j], j + 1
        return out

    def atom(self):
        c = self.peek()
        if c == "(":
            self.i += 1
            node = self.seq(")")
            self.i += 1
            return node
        if c == "*":
            self.i += 1
            return ("all",)
        if c != "@":
            raise ValueError(f"unsupported {c!r} in {self.s!r}")
        self.i += 1
        fld = self.until(":")
        c2 = self.s[self.i]
        self.i += 1
        if c2 == "{":
            return ("tag", fld, [v.strip().lower()
                                 for v in self.until("}").split("|")])
        if c2 == "[":
            lo, hi = self.until("]").split()
            return ("num", fld, float(lo), float(hi))
        raise ValueError(f"unsupported field clause in {self.s!r}")


# -------------------------------------------------------------- reference
class Reference:
    """The reference over a `Dataset`, in float64 or, for the control,
    in bfloat16."""

    def __init__(self, ds, precision: str = "float64"):
        self.ds = ds
        self.prec = precision
        self.n_live = ds.n
        self._row_of_key = None
        self._vec = {}

    def eval(self, node) -> np.ndarray:
        """The rows (ascending) that pass a filter node."""
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
        if kind == "or":
            return np.unique(np.concatenate([self.eval(c) for c in node[1]]))
        if kind == "and":
            pos = [c for c in node[1] if c[0] != "not"]
            rows = self.eval(pos[0]) if pos else self.eval(("all",))
            for c in pos[1:]:
                rows = np.intersect1d(rows, self.eval(c), assume_unique=True)
            for c in node[1]:
                if c[0] == "not":
                    rows = rows[~np.isin(rows, self.eval(c[1]),
                                         assume_unique=True)]
            return rows
        if kind == "not":
            return self.eval(("and", [node]))
        raise ValueError(f"unknown node {kind!r}")

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
        """A KNN query's answer: its total, the ranked rows, and the
        distance of every row that passes the filter (`rows`, `values`)."""
        node, knn = parse(query)
        if knn is None:
            raise ValueError(f"not a KNN query: {query!r}")
        rows = self.eval(node)
        kk, field, param = knn
        d = self.distances(field, params[param], rows)
        order = np.lexsort((rows, d))
        return {"total": min(kk, len(rows)), "rows": rows, "values": d,
                "ranked": rows[order[:min(kk, k)]]}

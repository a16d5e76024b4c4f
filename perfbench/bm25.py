"""Full-text postings and BM25STD scores for the plain reference, worked
out from the benchmark's own token arrays (`corpus.Text`).  It imports
nothing of the program.

**Postings** (`Postings`, one a TEXT field, built once): for each term of
the field's vocabulary, the rows that hold it (ascending), how often
each holds it, and where (token positions from 0 in the field).  They
are public, so that a reader can count what a text kernel has to move
from the benchmark's own data.

**Scores** (`TextIndex`), in float64, BM25STD as RediSearch computes it
(`src/ext/default.c`: `bm25StdRecursive`, `CalculateBM25Std`; the idf
of its `idf` crate, `calculate_idf_bm25`):

    idf(t)      = ln(1 + (N - n_t + 0.5) / (n_t + 0.5))
    score(t, d) = idf(t) * f * (k1 + 1) / (f + k1 * (1 - b + b * |d| / avgdl))

with k1 = 1.2 and b = 0.75; N the documents; n_t the documents that hold
t in any TEXT field; f the frequency of t in d, each occurrence adding
its field's weight (RediSearch's forward index adds the field's weight
to the record's frequency, `forward_index.c`); |d| the tokens of all of
d's TEXT fields; avgdl the mean of |d| over the N documents.  A term
under `@F:` keeps the documents that hold it in F, with the same f and
n_t (the record's field mask filters; its frequency is the record's).
An exact phrase "a b ..." holds d where its words stand at consecutive
positions of one field, in order, and scores as the intersection of its
terms.  How `reference.py` combines these: an intersection or a union
sums its children's scores at a document (a union, those of the
children that hold it), an optional child adds its score where it holds
the document, a negated one adds nothing, and a filter clause (a tag, a
numeric range, `*`) that holds a document adds its weight, 1.
"""

from __future__ import annotations

import numpy as np

K1 = 1.2
B = 0.75


class Postings:
    """One TEXT field's postings.  Term t (an id of the field's
    vocabulary) has the entries e in [term_off[t], term_off[t + 1]): row
    `rows[e]` (ascending within t), `tf[e]` occurrences, at positions
    `pos[pos_off[e]:pos_off[e + 1]]` (ascending)."""

    def __init__(self, text, n: int):
        ids, lens = text.ids, text.lens
        total = len(ids)
        start = np.concatenate([[0], np.cumsum(lens, dtype=np.int64)[:-1]])
        row = np.repeat(np.arange(n, dtype=np.int32), lens)
        pos = (np.arange(total, dtype=np.int64)
               - np.repeat(start, lens)).astype(np.int32)
        # rows ascend in token order, so a stable sort by term leaves
        # each term's tokens by row, then by position
        order = np.argsort(ids, kind="stable")
        sid, srow = ids[order], row[order]
        self.pos = pos[order]
        new = np.ones(total, bool)
        new[1:] = (sid[1:] != sid[:-1]) | (srow[1:] != srow[:-1])
        first = np.flatnonzero(new)
        self.rows = srow[first]
        self.pos_off = np.append(first, total)
        self.tf = np.diff(self.pos_off).astype(np.int32)
        self.term_off = np.searchsorted(sid[first],
                                        np.arange(len(text.words) + 1))
        self.stride = int(lens.max(initial=0)) + 2

    def entries(self, t: int) -> tuple:
        """(rows, tf) of term t."""
        a, b = self.term_off[t], self.term_off[t + 1]
        return self.rows[a:b], self.tf[a:b]

    def keys(self, t: int) -> np.ndarray:
        """Term t's occurrences as ascending keys row * stride + pos."""
        a, b = self.term_off[t], self.term_off[t + 1]
        rows = np.repeat(self.rows[a:b].astype(np.int64), self.tf[a:b])
        return rows * self.stride + self.pos[self.pos_off[a]:
                                             self.pos_off[b]]


class TextIndex:
    """The TEXT fields of a `Dataset`: postings, document lengths and
    the BM25STD score of each term and phrase."""

    def __init__(self, ds):
        self.fields = [f["name"] for f in ds.cfg["fields"]
                       if f["type"] == "TEXT"]
        self.weight = {f["name"]: float(f.get("weight", 1.0))
                       for f in ds.cfg["fields"] if f["type"] == "TEXT"}
        self.bit = {nm: 1 << j for j, nm in enumerate(self.fields)}
        self.post = {nm: Postings(ds.texts[nm], ds.n) for nm in self.fields}
        self.word_id = {nm: {w.lower(): i for i, w in
                             enumerate(ds.texts[nm].words.tolist())}
                        for nm in self.fields}
        self.n = ds.n
        self.doclen = np.zeros(ds.n, np.float64)
        for nm in self.fields:
            self.doclen += ds.texts[nm].lens
        self.avgdl = float(self.doclen.sum()) / max(ds.n, 1)
        self._terms: dict = {}

    def term(self, word: str) -> tuple:
        """(rows ascending, score at each, field mask at each) of a word
        over all TEXT fields."""
        got = self._terms.get(word)
        if got is not None:
            return got
        rows, f, bits = [], [], []
        for nm in self.fields:
            t = self.word_id[nm].get(word)
            if t is None:
                continue
            r, tf = self.post[nm].entries(t)
            rows.append(r)
            f.append(tf * self.weight[nm])
            bits.append(np.full(len(r), self.bit[nm], np.int64))
        if not rows:
            got = (np.zeros(0, np.int64), np.zeros(0), np.zeros(0, np.int64))
        else:
            u, inv = np.unique(np.concatenate(rows), return_inverse=True)
            freq = np.bincount(inv, weights=np.concatenate(f),
                               minlength=len(u))
            mask = np.zeros(len(u), np.int64)
            np.bitwise_or.at(mask, inv, np.concatenate(bits))
            got = (u.astype(np.int64), self.bm25(freq, u), mask)
        self._terms[word] = got
        return got

    def bm25(self, freq: np.ndarray, rows: np.ndarray) -> np.ndarray:
        """BM25STD of one term at `rows`, which are all the rows that
        hold it, with its weighted frequencies `freq`."""
        n_t = len(rows)
        idf = np.log1p((self.n - n_t + 0.5) / (n_t + 0.5))
        norm = K1 * (1.0 - B + B * self.doclen[rows] / self.avgdl)
        return idf * freq * (K1 + 1.0) / (freq + norm)

    def scoped(self, word: str, fields) -> tuple:
        """(rows, scores) of a term, restricted to `fields` (None: all)."""
        rows, score, mask = self.term(word)
        if fields is None:
            return rows, score
        bits = 0
        for nm in fields:
            if nm not in self.bit:
                raise ValueError(f"@{nm} is not a TEXT field")
            bits |= self.bit[nm]
        keep = (mask & bits) != 0
        return rows[keep], score[keep]

    def phrase(self, words: list) -> tuple:
        """(rows, scores) of an exact phrase in any TEXT field."""
        found = []
        for nm in self.fields:
            post = self.post[nm]
            keys = None
            for w in words:
                t = self.word_id[nm].get(w)
                if t is None:
                    keys = None
                    break
                kw = post.keys(t)
                keys = kw if keys is None else np.intersect1d(
                    keys + 1, kw, assume_unique=True)
            if keys is not None:
                found.append(keys // post.stride)
        rows = (np.unique(np.concatenate(found)) if found
                else np.zeros(0, np.int64))
        score = np.zeros(len(rows))
        for w in words:
            r, s, _ = self.term(w)
            score += s[np.searchsorted(r, rows)]
        return rows, score

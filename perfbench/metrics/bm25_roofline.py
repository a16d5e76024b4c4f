"""bm25_roofline: the least time the card needs for the full-text work
of the profiled batches, as a share of the union of device intervals in
them.

The work is counted from the benchmark's own postings (`bm25.py`, as
the reference's `TextIndex` holds them), never from the program's
arguments.  Per query, the posting lists that an exact answer has to
read in full:

* of a union (`a|b`), every child's lists: each document of each list
  is an answer, whose score needs its frequency;
* of an intersection (a sequence with its `-not` and `~optional`
  children, a phrase, a TAG filter), only its shortest required list
  (of the children neither negated nor optional): each of its documents
  is a candidate the answer has to decide, and the drawn documents lie
  at random over the whole id range, so no stretch of that list can be
  passed over unread; the longer lists can be probed;
* a term's list is its documents in any TEXT field, or under `@F:` in
  F; a phrase's is its shortest term's, whose positions it reads too.

Each distinct list is counted once a batch (a path that shares a
list's read among a batch's queries pays it once), at 8 bytes an entry:
a 4-byte document id and a 4-byte frequency, as RediSearch's records
and the port's posting arrays hold them; a TAG or NUMERIC list at 4
bytes an entry (ids only); a phrase's positions at 4 bytes an
occurrence.  Those bytes over the memory bandwidth (3.35 TB/s,
`peaks.json`, H100 SXM at 700 W) are the floor; the operations, a few
compares and adds an entry, take far less at any of the card's rates.
The denominator is the union of all device intervals in the profiled
batches: every kernel, copy and set of a cell of FT.SEARCH text queries
is that work, so whatever implements it, no honest path reads over
100%.  KNN queries are left out: cells with them list no such metric.
"""

from perfbench.reference import parse


def _occurrences(text, word: str) -> int:
    """Tokens of `word` over every TEXT field."""
    n = 0
    for nm in text.fields:
        t = text.word_id[nm].get(word)
        if t is not None:
            n += int(text.post[nm].entries(t)[1].sum())
    return n


def lists(ref, node) -> dict:
    """{list: bytes} that an exact answer to `node` reads in full."""
    kind = node[0]
    text = ref.text
    if kind == "term":
        _, fields, word = node
        return {("term", word, fields):
                8 * len(text.scoped(word, fields)[0])}
    if kind == "phrase":
        size = {w: len(text.term(w)[0]) for w in node[1]}
        w = min(node[1], key=lambda x: (size[x], x))
        return {("term", w, None): 8 * size[w],
                ("pos", w): 4 * _occurrences(text, w)}
    if kind == "or":
        out: dict = {}
        for child in node[1]:
            out.update(lists(ref, child))
        return out
    if kind == "and":
        req = [lists(ref, c) for c in node[1] if c[0] not in ("not", "opt")]
        return min(req, key=lambda d: sum(d.values())) if req else {}
    if kind in ("not", "opt", "all"):
        return {}
    return {(kind, *map(str, node[1:])): 4 * len(ref.eval(node))}


def read(run):
    d = run.device
    if not d or d["busy_s"] <= 0 or not run.profiled:
        return None
    t_min = 0.0
    for batch in run.profiled:
        need: dict = {}
        for q in batch.queries:
            node, knn = parse(q)
            if knn is None:
                need.update(lists(run.ref, node))
        t_min += sum(need.values()) / run.peaks["hbm_bytes_per_s"]
    if t_min <= 0:
        return None
    return 100.0 * t_min / d["busy_s"]

# Copy of redisearch_tpu/aux/highlight.py: the port imports nothing of the JAX package.
# It takes the planner's stemmer of the index's language (`stemmer_for`).
"""Highlighting & summarization (HIGHLIGHT / SUMMARIZE).

Reference: src/fragmenter.c (fragment scoring by term hits, design comment
fragmenter.h:7-31), src/highlight_processor.c, src/summarize_spec.c.

Host-side by design: highlighting needs the original document text, which
lives in the host doc store; the device index contributes the query's term
set (including stems/synonym expansions).  The field is re-tokenized and
token hits are wrapped in tags (HIGHLIGHT) or scored fragments are extracted
(SUMMARIZE), mirroring the reference's re-tokenize + fragment approach.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from ..analysis.stemmer import Stemmer
from ..analysis.tokenizer import Tokenizer
from ..query.engine import stemmer_for


@dataclasses.dataclass
class HighlightOptions:
    open_tag: str = "<b>"
    close_tag: str = "</b>"


@dataclasses.dataclass
class SummarizeOptions:
    frag_len: int = 20          # tokens per fragment (reference default 20)
    num_frags: int = 3
    separator: str = "... "


def _query_term_set(index, query_ast) -> set[str]:
    """All concrete match terms: tokens + their stems."""
    from ..query import ast as A
    stemmer = stemmer_for(index.schema.language)
    out: set[str] = set()
    for node in A.walk(query_ast):
        if isinstance(node, A.TokenNode):
            out.add(node.term)
            st = stemmer.stem(node.term)
            if st:
                out.add(st)
        elif isinstance(node, A.AffixNode):
            out.add(("prefix:" if node.prefix else "") + node.text)
        elif isinstance(node, A.PhraseNode):
            for t in node.terms:
                if isinstance(t, A.TokenNode):
                    out.add(t.term)
    return out


def _token_matches(tok, terms: set[str], stemmer: Stemmer) -> bool:
    if tok.tok in terms:
        return True
    st = stemmer.stem(tok.tok)
    if st and st in terms:
        return True
    for t in terms:
        if t.startswith("prefix:") and tok.tok.startswith(t[7:]):
            return True
    return False


def highlight_field(index, text: str, query_ast,
                    opts: Optional[HighlightOptions] = None) -> str:
    """Wrap matched tokens in tags (byte-accurate via token offsets)."""
    opts = opts or HighlightOptions()
    terms = _query_term_set(index, query_ast)
    stemmer = stemmer_for(index.schema.language)
    tk = Tokenizer(index.stopwords)
    out = []
    last = 0
    for tok in tk.tokenize(text):
        if _token_matches(tok, terms, stemmer):
            b = text.encode("utf-8")
            pre = b[last:tok.start_byte].decode("utf-8")
            body = b[tok.start_byte:tok.end_byte].decode("utf-8")
            out.append(pre)
            out.append(opts.open_tag + body + opts.close_tag)
            last = tok.end_byte
    out.append(text.encode("utf-8")[last:].decode("utf-8"))
    return "".join(out)


def summarize_field(index, text: str, query_ast,
                    s_opts: Optional[SummarizeOptions] = None,
                    h_opts: Optional[HighlightOptions] = None) -> str:
    """Extract the highest-scoring fragments around term hits.

    Fragment score = sum of hit weights with distinct-term bonus
    (reference: fragmenter scoring, fragmenter.h:7-31).
    """
    s_opts = s_opts or SummarizeOptions()
    terms = _query_term_set(index, query_ast)
    stemmer = stemmer_for(index.schema.language)
    tk = Tokenizer(index.stopwords)
    toks = list(tk.tokenize(text))
    if not toks:
        return ""
    hits = [i for i, t in enumerate(toks)
            if _token_matches(t, terms, stemmer)]
    if not hits:
        # no hits: leading fragment
        frag = toks[:s_opts.frag_len]
        b = text.encode("utf-8")
        return b[frag[0].start_byte:frag[-1].end_byte].decode("utf-8")

    # score windows of frag_len tokens anchored at each hit
    windows: list[tuple[float, int, int]] = []
    for h in hits:
        start = max(0, h - s_opts.frag_len // 4)
        end = min(len(toks), start + s_opts.frag_len)
        seen = set()
        score = 0.0
        for i in range(start, end):
            if i in hits:
                tokv = toks[i].tok
                score += 2.0 if tokv not in seen else 1.0
                seen.add(tokv)
        windows.append((score, start, end))
    windows.sort(key=lambda w: (-w[0], w[1]))

    chosen: list[tuple[int, int]] = []
    for score, start, end in windows:
        if any(not (end <= s or start >= e) for s, e in chosen):
            continue  # overlaps an already chosen fragment
        chosen.append((start, end))
        if len(chosen) >= s_opts.num_frags:
            break
    chosen.sort()

    b = text.encode("utf-8")
    parts = []
    for start, end in chosen:
        frag_text = b[toks[start].start_byte:toks[end - 1].end_byte].decode(
            "utf-8")
        if h_opts is not None:
            frag_text = highlight_field(index, frag_text, query_ast, h_opts)
        parts.append(frag_text)
    return s_opts.separator.join(parts) + (
        s_opts.separator.rstrip() if parts else "")

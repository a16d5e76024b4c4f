# Copy of redisearch_tpu/analysis/cjk.py: the port imports nothing of the JAX package.
"""Chinese word segmentation: MMSEG complex mode over the friso lexicon.

Reference: deps/friso (the MMSEG algorithm, friso_UTF8.c complex mode) +
src/tokenize_cn.c; the reference bundles the same lexicon data via
deps/cndict/bundle_friso.py.  Round 1 approximated Chinese with CJK
bigrams; dictionary segmentation matches the reference's token stream.

The segmenter is the published MMSEG algorithm (Tsai 2000), implemented
from its description: at each position enumerate 3-word chunks and pick
the first word of the best chunk by four tie-breaking rules —
  1. maximum total chunk length,
  2. largest average word length,
  3. smallest variance of word lengths,
  4. largest sum of single-character degree of morphemic freedom
     (log frequency from the character lexicon).
Characters not in the dictionary segment as single-char tokens.

The bundled dictionary (data/cn_words.txt.gz, cn_chars.txt.gz) is the
friso project's lexicon — third-party dictionary DATA (like the default
stopword list), required for behavioral parity, stored as compressed
word lists.
"""

from __future__ import annotations

import gzip
import math
import os
from typing import Optional

_MAX_WORD = 7          # friso default max CJK match length

_dict: Optional[set] = None
_freq: Optional[dict] = None
_maxlen: int = _MAX_WORD


def _load() -> tuple[set, dict]:
    global _dict, _freq, _maxlen
    if _dict is None:
        base = os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "data")
        words: set[str] = set()
        try:
            with gzip.open(os.path.join(base, "cn_words.txt.gz"), "rt",
                           encoding="utf-8") as f:
                for line in f:
                    w = line.strip()
                    if w:
                        words.add(w)
        except OSError:
            pass
        freq: dict[str, float] = {}
        try:
            with gzip.open(os.path.join(base, "cn_chars.txt.gz"), "rt",
                           encoding="utf-8") as f:
                for line in f:
                    parts = line.rstrip("\n").split("\t")
                    if len(parts) == 2:
                        try:
                            freq[parts[0]] = math.log(
                                float(parts[1]) + 1.0)
                        except ValueError:
                            pass
        except OSError:
            pass
        _dict = words
        _freq = freq
        _maxlen = max((len(w) for w in words), default=_MAX_WORD)
    return _dict, _freq


def dict_available() -> bool:
    words, _ = _load()
    return len(words) > 0


def _matches(text: str, i: int, words: set) -> list[int]:
    """Lengths of dictionary words starting at i (always includes 1)."""
    out = []
    limit = min(_maxlen, _MAX_WORD, len(text) - i)
    for L in range(limit, 1, -1):
        if text[i:i + L] in words:
            out.append(L)
    out.append(1)
    return out


def mmseg(text: str) -> list[str]:
    """Segment a CJK run into words (MMSEG complex)."""
    words, freq = _load()
    out: list[str] = []
    i = 0
    n = len(text)
    while i < n:
        m1 = _matches(text, i, words)
        if len(m1) == 1 and m1[0] == 1:
            out.append(text[i])
            i += 1
            continue
        # enumerate 3-word chunks
        best = None     # (key tuple, first_len)
        for l1 in m1:
            j = i + l1
            m2 = _matches(text, j, words) if j < n else [0]
            for l2 in m2:
                k2 = j + l2
                m3 = _matches(text, k2, words) if k2 < n else [0]
                for l3 in m3:
                    lens = [x for x in (l1, l2, l3) if x > 0]
                    total = sum(lens)
                    avg = total / len(lens)
                    var = sum((x - avg) ** 2 for x in lens) / len(lens)
                    dmf = 0.0
                    pos = i
                    for x in (l1, l2, l3):
                        if x == 1:
                            dmf += freq.get(text[pos], 0.0)
                        pos += x
                    key = (total, avg, -var, dmf)
                    if best is None or key > best[0]:
                        best = (key, l1)
        L = best[1] if best is not None else 1
        out.append(text[i:i + L])
        i += L
    return out

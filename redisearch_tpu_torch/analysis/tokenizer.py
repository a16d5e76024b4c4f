# Copy of redisearch_tpu/analysis/tokenizer.py: the port imports nothing of the JAX package.
"""Tokenizer (reference: src/tokenize.c, src/toksep.h).

Separator-driven tokenization with unicode casefolding, position tracking,
byte offsets, stopword removal and optional per-token stemming — the host
side of the indexing path.  The reference tokenizes on the main Redis thread
per document; here documents are tokenized in batch on the host before the
device segment build, so this code is plain Python optimized for clarity.

Escape handling matches the reference: a backslash escapes the following
separator character into the token (toksep.h istoksep + escape logic).
"""

from __future__ import annotations

import dataclasses
import unicodedata
from typing import Iterator, Optional

from .stemmer import Stemmer
from .stopwords import StopWordList

# The reference's separator set (src/toksep.h ToksepMap_g): ascii
# punctuation + whitespace + control chars.
_SEPARATORS = set(" \t\r\n!\"#$%&'()*+,-./:;<=>?@[\\]^`{|}~")


def is_separator(ch: str) -> bool:
    return ch in _SEPARATORS or unicodedata.category(ch).startswith("Z")


def _is_cjk(ch: str) -> bool:
    cp = ord(ch)
    return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
            or 0xF900 <= cp <= 0xFAFF or 0x3040 <= cp <= 0x30FF)


def cjk_segment(token: str) -> list[str]:
    """Segmentation for CJK runs (reference: src/tokenize_cn.c +
    deps/friso MMSEG complex mode).  Dictionary segmentation via the
    bundled friso lexicon (analysis/cjk.py); overlapping bigrams remain
    the fallback when the dictionary data is unavailable — a query
    segmented the same way always matches either way."""
    if len(token) == 1:
        return [token]
    from . import cjk
    if cjk.dict_available():
        return cjk.mmseg(token)
    return [token[i:i + 2] for i in range(len(token) - 1)]


def normalize_token(tok: str) -> str:
    """Unicode casefold (reference uses libnu nu_tolower per rune)."""
    return tok.casefold()


@dataclasses.dataclass
class Token:
    """One token (reference: Token struct, src/tokenize.h:24-60)."""

    raw: str            # original surface form
    tok: str            # normalized (casefolded) form
    stem: Optional[str]  # stemmed form, or None
    pos: int            # 1-based token position in the field
    start_byte: int     # byte offset of raw token start (for highlighting)
    end_byte: int        # byte offset one past raw token end
    is_stopword: bool = False


class Tokenizer:
    """Simple separator tokenizer (reference: simpleTokenizer, tokenize.c).

    Yields Tokens with increasing positions.  Stopwords are yielded with
    is_stopword=True (they consume a position but are not indexed), matching
    the reference's position accounting.
    """

    def __init__(
        self,
        stopwords: Optional[StopWordList] = None,
        stemmer: Optional[Stemmer] = None,
        min_stem_len: int = 4,
    ):
        self.stopwords = stopwords or StopWordList()
        self.stemmer = stemmer
        self.min_stem_len = min_stem_len  # reference: MIN_STEM_CANDIDATE_LEN

    def tokenize(self, text: str) -> Iterator[Token]:
        pos = 0
        i = 0
        n = len(text)
        # Running byte offset of text[:i] (tokens report byte offsets so the
        # highlighter can slice the original utf-8 document).
        byte_i = 0
        while i < n:
            # skip separators
            while i < n and is_separator(text[i]):
                byte_i += len(text[i].encode("utf-8"))
                i += 1
            if i >= n:
                break
            start = i
            start_byte = byte_i
            parts: list[str] = []
            while i < n:
                ch = text[i]
                if ch == "\\" and i + 1 < n and is_separator(text[i + 1]):
                    parts.append(text[i + 1])
                    byte_i += len(ch.encode("utf-8"))
                    byte_i += len(text[i + 1].encode("utf-8"))
                    i += 2
                    continue
                if is_separator(ch):
                    break
                parts.append(ch)
                byte_i += len(ch.encode("utf-8"))
                i += 1
            raw = text[start:i] if not parts else "".join(parts)
            if not raw:
                continue
            norm = normalize_token("".join(parts) if parts else raw)
            # CJK runs split into overlapping bigrams, each its own position
            if any(_is_cjk(c) for c in norm):
                for gram in cjk_segment(norm):
                    pos += 1
                    yield Token(gram, gram, None, pos, start_byte, byte_i)
                continue
            pos += 1
            if norm in self.stopwords:
                yield Token(raw, norm, None, pos, start_byte, byte_i, True)
                continue
            stem = None
            if self.stemmer is not None and len(norm) >= self.min_stem_len:
                stem = self.stemmer.stem(norm)
            yield Token(raw, norm, stem, pos, start_byte, byte_i)

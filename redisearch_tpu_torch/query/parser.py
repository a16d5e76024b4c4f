# Copy of redisearch_tpu/query/parser.py: the port imports nothing of the JAX package.
"""Recursive-descent parser for the RediSearch query language (dialect 2,
with dialect-1 compatibility switches).

The grammar implemented here is specified by the reference's Lemon grammar
(src/query_parser/v2/parser.y:323-1244 + lexer.rl); this is a from-scratch
recursive-descent implementation of the same language:

  AND by juxtaposition, OR with `|`, `-` negation, `~` optional,
  "exact phrase", field scoping @f: / @a|b:(...), prefix*/*suffix/*infix*,
  %fuzzy% (1-3 edits), w'wildcard', verbatim 'quoted', tags @t:{a|b*},
  numeric @n:[lo hi] and operators @n>5 @n<=3 @n==4 @n!=2,
  geo @g:[lon lat r unit], geometry @g:[WITHIN $poly],
  KNN (expr)=>[KNN $k @v $blob ...], range @v:[VECTOR_RANGE r $blob],
  => {$weight:…; $slop:…; $inorder:…; $phonetic:…; $yield_distance_as:…},
  ismissing(@f), `*` match-all, $param substitution.
"""

from __future__ import annotations

import math
from typing import Any, Optional

import numpy as np

from ..analysis.stopwords import StopWordList
from ..analysis.tokenizer import normalize_token
from ..utils.errors import ParamError, QuerySyntaxError
from . import ast

# Characters that terminate an unquoted term (reference lexer.rl punctuation).
_TERM_STOP = set(" \t\r\n()|{}[]\"'~-@:;*%$,=><!")
# of those, chars that may appear mid-term without whitespace meaning
_PUNCT_SELF = set("*")


class _Cursor:
    def __init__(self, s: str):
        self.s = s
        self.i = 0
        self.n = len(s)

    def eof(self) -> bool:
        return self.i >= self.n

    def peek(self, off: int = 0) -> str:
        j = self.i + off
        return self.s[j] if j < self.n else ""

    def startswith(self, txt: str) -> bool:
        return self.s.startswith(txt, self.i)

    def skip_ws(self):
        while self.i < self.n and self.s[self.i] in " \t\r\n":
            self.i += 1

    def expect(self, ch: str):
        if not self.startswith(ch):
            raise QuerySyntaxError(
                f"Syntax error at offset {self.i} near "
                f"{self.s[self.i:self.i+10]!r}: expected {ch!r}")
        self.i += len(ch)

    def error(self, msg: str):
        raise QuerySyntaxError(f"Syntax error at offset {self.i}: {msg}")


class QueryParser:
    def __init__(
        self,
        params: Optional[dict[str, Any]] = None,
        stopwords: Optional[StopWordList] = None,
        dialect: int = 2,
    ):
        self.params = params or {}
        # explicit `is None` check: an EMPTY StopWordList (len 0, falsy)
        # is meaningful — NOSTOPWORDS parses with no stopword filtering
        self.stopwords = (StopWordList() if stopwords is None
                          else stopwords)
        self.dialect = dialect

    # -- public ------------------------------------------------------------
    def parse(self, query: str) -> ast.Node:
        cur = _Cursor(query)
        cur.skip_ws()
        if cur.eof():
            return ast.WildcardNode()
        if self.dialect == 1:
            return self._parse_d1_query(cur)
        node = self._parse_or(cur)
        cur.skip_ws()
        if not cur.eof():
            cur.error(f"unexpected trailing input {cur.s[cur.i:]!r}")
        if node is None:
            return ast.EmptyNode()
        return node

    # -- params --------------------------------------------------------------
    def _param(self, name: str) -> Any:
        if name not in self.params:
            raise ParamError(f"No such parameter `{name}`")
        return self.params[name]

    def _maybe_param_str(self, tok: str) -> str:
        if tok.startswith("$"):
            return str(self._param(tok[1:]))
        return tok

    def _maybe_param_num(self, tok: str) -> float:
        if tok.startswith("$"):
            tok = str(self._param(tok[1:]))
        t = tok.lower()
        if t in ("inf", "+inf", "infinity"):
            return math.inf
        if t == "-inf":
            return -math.inf
        try:
            return float(tok)
        except ValueError:
            raise QuerySyntaxError(f"bad numeric value {tok!r}")

    # -- expression levels -----------------------------------------------
    def _parse_or(self, cur: _Cursor) -> Optional[ast.Node]:
        kids = []
        left = self._parse_and(cur)
        if left is not None:
            kids.append(left)
        while True:
            cur.skip_ws()
            if cur.peek() == "|":
                cur.i += 1
                right = self._parse_and(cur)
                if right is not None:
                    kids.append(right)
            else:
                break
        if not kids:
            return None
        if len(kids) == 1:
            return kids[0]
        return ast.UnionNode(kids=kids)

    def _parse_and(self, cur: _Cursor) -> Optional[ast.Node]:
        kids = []
        while True:
            cur.skip_ws()
            if cur.eof() or cur.peek() in ")|":
                break
            node = self._parse_unary(cur)
            if node is not None:
                kids.append(node)
        if not kids:
            return None
        if len(kids) == 1:
            return kids[0]
        return ast.IntersectNode(kids=kids)

    def _parse_unary(self, cur: _Cursor) -> Optional[ast.Node]:
        cur.skip_ws()
        ch = cur.peek()
        if ch == "-" and not self._is_negative_number(cur):
            cur.i += 1
            child = self._parse_unary(cur)
            if child is None:
                cur.error("dangling `-`")
            return self._arrows(cur, ast.NotNode(child=child))
        if ch == "~":
            cur.i += 1
            child = self._parse_unary(cur)
            if child is None:
                cur.error("dangling `~`")
            return self._arrows(cur, ast.OptionalNode(child=child))
        node = self._parse_primary(cur)
        if node is None:
            return None
        return self._arrows(cur, node)

    def _is_negative_number(self, cur: _Cursor) -> bool:
        # `-2` as a bare term is a token, not negation of 2 (lexer nuance).
        nxt = cur.peek(1)
        return nxt.isdigit() and False  # reference treats -2 as NOT(2); keep

    # -- `=>` suffixes ------------------------------------------------------
    def _arrows(self, cur: _Cursor, node: ast.Node) -> ast.Node:
        while True:
            cur.skip_ws()
            if cur.startswith("=>"):
                save = cur.i
                cur.i += 2
                cur.skip_ws()
                if cur.peek() == "[":
                    node = self._parse_knn(cur, node)
                elif cur.peek() == "{":
                    self._parse_attrs(cur, node)
                else:
                    cur.i = save
                    break
            else:
                break
        return node

    def _parse_attrs(self, cur: _Cursor, node: ast.Node):
        """=> { $weight: 0.5; $slop: 2; $inorder: true; ... }"""
        cur.expect("{")
        while True:
            cur.skip_ws()
            if cur.peek() == "}":
                cur.i += 1
                break
            if cur.peek() != "$":
                cur.error("expected $attribute")
            cur.i += 1
            name = self._read_ident(cur).lower()
            cur.skip_ws()
            cur.expect(":")
            cur.skip_ws()
            val = self._read_until(cur, ";}")
            val = val.strip()
            cur.skip_ws()
            if cur.peek() == ";":
                cur.i += 1
            if name == "weight":
                node.weight = self._maybe_param_num(val)
            elif name == "slop" and isinstance(node, ast.PhraseNode):
                node.slop = int(self._maybe_param_num(val))
                node.exact = False
            elif name == "inorder" and isinstance(node, ast.PhraseNode):
                node.inorder = val.lower() in ("true", "1")
            elif name == "phonetic":
                if isinstance(node, ast.TokenNode):
                    node.verbatim = val.lower() in ("false", "0")
            elif name == "yield_distance_as":
                if isinstance(node, ast.VectorNode):
                    node.score_alias = val
            # unknown attrs are ignored (reference raises; relaxed here)

    def _parse_knn(self, cur: _Cursor, filter_node: ast.Node) -> ast.Node:
        """(filter)=>[KNN <k> @field $blob <params>... AS alias]"""
        cur.expect("[")
        cur.skip_ws()
        kw = self._read_ident(cur)
        if kw.upper() != "KNN":
            cur.error(f"expected KNN, got {kw!r}")
        cur.skip_ws()
        ktok = self._read_until(cur, " \t@")
        k = int(self._maybe_param_num(ktok.strip()))
        cur.skip_ws()
        cur.expect("@")
        field = self._read_ident(cur)
        cur.skip_ws()
        blob, bname = self._read_blob(cur)
        vn = ast.VectorNode(field=field, mode="KNN", blob=blob, k=k,
                            blob_param=bname)
        if not isinstance(filter_node, ast.WildcardNode):
            vn.child = filter_node
        # optional runtime params + AS
        while True:
            cur.skip_ws()
            if cur.peek() == "]":
                cur.i += 1
                break
            name = self._read_ident(cur).upper()
            cur.skip_ws()
            if name == "AS":
                vn.score_alias = self._read_ident(cur)
            elif name == "EF_RUNTIME":
                vn.ef_runtime = int(self._maybe_param_num(
                    self._read_until(cur, " \t]")))
            elif name == "BATCH_SIZE":
                vn.batch_size = int(self._maybe_param_num(
                    self._read_until(cur, " \t]")))
            elif name == "HYBRID_POLICY":
                vn.hybrid_policy = self._maybe_param_str(
                    self._read_until(cur, " \t]")).upper()
            elif name == "EPSILON":
                vn.epsilon = self._maybe_param_num(
                    self._read_until(cur, " \t]"))
            else:
                cur.error(f"unknown KNN param {name!r}")
        return vn

    def _read_blob(self, cur: _Cursor):
        if cur.peek() == "$":
            cur.i += 1
            name = self._read_ident(cur)
            val = self._param(name)
            return _coerce_vector(val), name
        cur.error("expected $blob parameter for vector query")

    # -- primaries --------------------------------------------------------
    def _parse_primary(self, cur: _Cursor) -> Optional[ast.Node]:
        cur.skip_ws()
        ch = cur.peek()
        if ch == "(":
            cur.i += 1
            node = self._parse_or(cur)
            cur.skip_ws()
            cur.expect(")")
            return node
        if ch == "*":
            # match-all, or *suffix / *infix*
            if cur.peek(1) and cur.peek(1) not in " \t\r\n)|=":
                return self._parse_affix(cur, None)
            cur.i += 1
            return ast.WildcardNode()
        if ch == "@":
            return self._parse_field_scoped(cur)
        if ch == '"':
            return self._parse_exact_phrase(cur)
        if ch == "'":
            return self._parse_verbatim(cur)
        if ch == "%":
            return self._parse_fuzzy(cur)
        if cur.startswith("w'") or cur.startswith('w"'):
            return self._parse_wildcard_query(cur)
        if cur.startswith("ismissing("):
            cur.i += len("ismissing(")
            cur.skip_ws()
            cur.expect("@")
            field = self._read_ident(cur)
            cur.skip_ws()
            cur.expect(")")
            return ast.MissingNode(field=field)
        if ch == "$":
            cur.i += 1
            name = self._read_ident(cur)
            val = str(self._param(name))
            return self._token_or_none(val)
        if ch in ")|":
            return None
        if ch in "}]":
            cur.error(f"unexpected {ch!r}")
        return self._parse_term(cur)

    def _parse_field_scoped(self, cur: _Cursor) -> Optional[ast.Node]:
        cur.expect("@")
        fields = [self._read_ident(cur)]
        while cur.peek() == "|":
            cur.i += 1
            if cur.peek() == "@":
                cur.i += 1
            fields.append(self._read_ident(cur))
        cur.skip_ws()
        # dialect-2 numeric operators: @f>5, @f<=3, @f==x, @f!=y
        two = cur.s[cur.i:cur.i + 2]
        if two in (">=", "<=", "==", "!="):
            cur.i += 2
            val = self._maybe_param_num(self._read_until_term_end(cur))
            return self._numeric_op(fields[0], two, val)
        if cur.peek() in "<>":
            op = cur.peek()
            cur.i += 1
            val = self._maybe_param_num(self._read_until_term_end(cur))
            return self._numeric_op(fields[0], op, val)
        cur.expect(":")
        cur.skip_ws()
        ch = cur.peek()
        if ch == "{":
            return self._parse_tag(cur, fields[0])
        if ch == "[":
            return self._parse_bracket(cur, fields[0])
        node = self._parse_unary(cur)
        if node is None:
            cur.error(f"empty field scope for @{'|'.join(fields)}")
        _apply_fieldmask(node, fields)
        return node

    def _numeric_op(self, field: str, op: str, val: float) -> ast.NumericNode:
        if op == ">":
            return ast.NumericNode(field=field, lo=val, lo_excl=True)
        if op == ">=":
            return ast.NumericNode(field=field, lo=val)
        if op == "<":
            return ast.NumericNode(field=field, hi=val, hi_excl=True)
        if op == "<=":
            return ast.NumericNode(field=field, hi=val)
        if op == "==":
            return ast.NumericNode(field=field, lo=val, hi=val)
        # != -> NOT(==)
        return ast.NotNode(child=ast.NumericNode(field=field, lo=val, hi=val))

    def _parse_bracket(self, cur: _Cursor, field: str) -> ast.Node:
        """@f:[...] — numeric range, geo radius, geometry, or vector range."""
        cur.expect("[")
        cur.skip_ws()
        save = cur.i
        first = self._read_until(cur, " \t]")
        up = first.upper()
        if up in ("WITHIN", "CONTAINS", "INTERSECTS", "DISJOINT"):
            cur.skip_ws()
            if cur.peek() == "$":
                cur.i += 1
                wkt_txt = str(self._param(self._read_ident(cur)))
            else:
                wkt_txt = self._read_quoted_or_bare(cur, "]")
            cur.skip_ws()
            cur.expect("]")
            return ast.GeometryNode(field=field, predicate=up, wkt=wkt_txt)
        if up == "VECTOR_RANGE":
            cur.skip_ws()
            radius = self._maybe_param_num(self._read_until(cur, " \t"))
            cur.skip_ws()
            blob, bname = self._read_blob(cur)
            cur.skip_ws()
            cur.expect("]")
            return ast.VectorNode(field=field, mode="RANGE", blob=blob,
                                  radius=radius, blob_param=bname)
        # numeric or geo: parse space-separated args until ]
        cur.i = save
        args = []
        while True:
            cur.skip_ws()
            if cur.peek() == "]":
                cur.i += 1
                break
            if cur.eof():
                cur.error("unterminated [")
            args.append(self._read_until(cur, " \t]"))
        if len(args) == 2:
            lo_raw, hi_raw = args
            lo_excl = lo_raw.startswith("(")
            hi_excl = hi_raw.startswith("(")
            lo = self._maybe_param_num(lo_raw[1:] if lo_excl else lo_raw)
            hi = self._maybe_param_num(hi_raw[1:] if hi_excl else hi_raw)
            return ast.NumericNode(field=field, lo=lo, hi=hi,
                                   lo_excl=lo_excl, hi_excl=hi_excl)
        if len(args) == 4:
            lon = self._maybe_param_num(args[0])
            lat = self._maybe_param_num(args[1])
            radius = self._maybe_param_num(args[2])
            unit = self._maybe_param_str(args[3]).lower()
            if unit not in ("m", "km", "mi", "ft"):
                raise QuerySyntaxError(f"bad geo unit {unit!r}")
            return ast.GeoNode(field=field, lon=lon, lat=lat, radius=radius,
                               unit=unit)
        raise QuerySyntaxError(
            f"bad bracket expression for @{field}: {args}")

    def _parse_tag(self, cur: _Cursor, field: str) -> ast.TagNode:
        cur.expect("{")
        kids: list[ast.Node] = []
        while True:
            cur.skip_ws()
            if cur.peek() == "}":
                cur.i += 1
                break
            if cur.eof():
                cur.error("unterminated {")
            ch = cur.peek()
            if ch == '"':
                txt = self._read_quoted(cur, '"')
                kids.append(ast.TokenNode(term=txt, verbatim=True))
            elif ch == "'":
                txt = self._read_quoted(cur, "'")
                kids.append(ast.TokenNode(term=txt, verbatim=True))
            elif ch == "%":
                kids.append(self._parse_fuzzy(cur))
            elif cur.startswith("w'") or cur.startswith('w"'):
                kids.append(self._parse_wildcard_query(cur))
            elif ch == "$":
                cur.i += 1
                val = str(self._param(self._read_ident(cur)))
                kids.append(ast.TokenNode(term=val, verbatim=True))
            else:
                # bare value, may end with * (prefix) or start with *
                txt = self._read_tag_value(cur)
                suffix = txt.startswith("*")
                prefix = txt.endswith("*") and not txt.endswith("\\*")
                core = txt[1 if suffix else 0: -1 if prefix else None]
                if (suffix or prefix) and core:
                    kids.append(ast.AffixNode(text=core, prefix=prefix,
                                              suffix=suffix))
                else:
                    kids.append(ast.TokenNode(term=txt, verbatim=True))
            cur.skip_ws()
            if cur.peek() == "|":
                cur.i += 1
        return ast.TagNode(field=field, kids=kids)

    def _parse_exact_phrase(self, cur: _Cursor, quote: str = '"'
                            ) -> ast.Node:
        txt = self._read_quoted(cur, quote, keep_escapes=True)
        toks = _split_terms(txt)
        kids = []
        for t in toks:
            norm = normalize_token(t)
            if norm in self.stopwords:
                continue
            kids.append(ast.TokenNode(term=norm, verbatim=True))
        if not kids:
            return ast.EmptyNode()
        if len(kids) == 1:
            return kids[0]
        return ast.PhraseNode(terms=kids, exact=True, inorder=True)

    def _parse_verbatim(self, cur: _Cursor) -> ast.Node:
        """Single-quoted string: identical verbatim semantics to double
        quotes — content is TOKENIZED (punctuation like a trailing `*`
        never reaches the term dict) and expansion is skipped
        (reference: tests/pytests/test_quotes.py — '...' == \"...\")."""
        return self._parse_exact_phrase(cur, quote="'")

    def _parse_fuzzy(self, cur: _Cursor) -> ast.FuzzyNode:
        dist = 0
        while cur.peek() == "%":
            cur.i += 1
            dist += 1
        if dist > 3:
            cur.error("fuzzy distance > 3")
        term = self._read_term_text(cur)
        for _ in range(dist):
            cur.expect("%")
        return ast.FuzzyNode(term=normalize_token(term), max_dist=dist)

    def _parse_wildcard_query(self, cur: _Cursor) -> ast.WildcardQueryNode:
        cur.i += 1  # w
        quote = cur.peek()
        pat = self._read_quoted(cur, quote)
        return ast.WildcardQueryNode(pattern=normalize_token(pat))

    def _parse_affix(self, cur: _Cursor, _field) -> ast.Node:
        """*suffix or *inf*ix* — leading-star patterns."""
        cur.expect("*")
        text = self._read_term_text(cur)
        prefix = False
        if cur.peek() == "*":
            cur.i += 1
            prefix = True
        return ast.AffixNode(text=normalize_token(text), prefix=prefix,
                             suffix=True)

    def _parse_term(self, cur: _Cursor) -> Optional[ast.Node]:
        text = self._read_term_text(cur)
        if not text:
            cur.error(f"unexpected character {cur.peek()!r}")
        if cur.peek() == "*":
            cur.i += 1
            # infix if another * follows the text? handled in _parse_affix
            return ast.AffixNode(text=normalize_token(text), prefix=True)
        return self._token_or_none(text)

    def _token_or_none(self, text: str) -> Optional[ast.Node]:
        norm = normalize_token(text)
        if norm in self.stopwords:
            return None
        # CJK runs match the index-side bigram segmentation as an exact
        # phrase (analysis/tokenizer.py cjk_segment)
        from ..analysis.tokenizer import _is_cjk, cjk_segment
        if any(_is_cjk(c) for c in norm):
            grams = cjk_segment(norm)
            if len(grams) == 1:
                return ast.TokenNode(term=grams[0], verbatim=True)
            return ast.PhraseNode(
                terms=[ast.TokenNode(term=g, verbatim=True)
                       for g in grams], exact=True, inorder=True)
        return ast.TokenNode(term=norm)

    # -- low-level readers -------------------------------------------------
    def _read_ident(self, cur: _Cursor) -> str:
        start = cur.i
        while not cur.eof() and (cur.peek().isalnum() or cur.peek() in "_-."):
            cur.i += 1
        if cur.i == start:
            cur.error("expected identifier")
        return cur.s[start:cur.i]

    def _read_until(self, cur: _Cursor, stops: str) -> str:
        start = cur.i
        while not cur.eof() and cur.peek() not in stops:
            cur.i += 1
        return cur.s[start:cur.i]

    def _read_until_term_end(self, cur: _Cursor) -> str:
        cur.skip_ws()
        start = cur.i
        while not cur.eof() and cur.peek() not in " \t\r\n)|]}":
            cur.i += 1
        return cur.s[start:cur.i]

    def _read_term_text(self, cur: _Cursor) -> str:
        parts = []
        while not cur.eof():
            ch = cur.peek()
            if ch == "\\" and cur.peek(1):
                parts.append(cur.peek(1))
                cur.i += 2
                continue
            if ch in _TERM_STOP:
                break
            parts.append(ch)
            cur.i += 1
        return "".join(parts)

    def _read_tag_value(self, cur: _Cursor) -> str:
        parts = []
        while not cur.eof():
            ch = cur.peek()
            if ch == "\\" and cur.peek(1):
                parts.append(cur.peek(1))
                cur.i += 2
                continue
            if ch in "|}":
                break
            parts.append(ch)
            cur.i += 1
        return "".join(parts).strip()

    def _read_quoted(self, cur: _Cursor, quote: str,
                     keep_escapes: bool = False) -> str:
        """keep_escapes=True preserves backslash sequences so downstream
        term-splitting can honor them (escaped punctuation stays in the
        term: `"James\\!\\*"` -> term `james!*`, reference
        tests/pytests/test_quotes.py test_verbatim_escaping)."""
        cur.expect(quote)
        parts = []
        while not cur.eof() and cur.peek() != quote:
            ch = cur.peek()
            if ch == "\\" and cur.peek(1):
                if keep_escapes:
                    parts.append("\\")
                parts.append(cur.peek(1))
                cur.i += 2
                continue
            parts.append(ch)
            cur.i += 1
        cur.expect(quote)
        return "".join(parts)

    def _read_quoted_or_bare(self, cur: _Cursor, stops: str) -> str:
        if cur.peek() in "\"'":
            return self._read_quoted(cur, cur.peek())
        return self._read_until(cur, stops).strip()


    # ======================================================================
    # Dialect 1 (the legacy grammar, src/query_parser/v1/parser.y +
    # lexer.rl).  Not a restriction of dialect 2 — a different language:
    #   * consecutive terms form a "termlist" phrase, so field modifiers
    #     and `-`/`~` absorb the whole run: `@t:a b` scopes BOTH a and b,
    #     `-a b` negates (a AND b)  (parser.y v1 termlist + precedences);
    #   * unions take the whole preceding termlist as the left arm:
    #     `a b|c` = (a b)|c  (v1 `union ::= expr OR expr` + TERMLIST prec);
    #   * nested modifiers intersect masks: `@t1:@t2:x` matches nothing
    #     when t1/t2 differ (QueryNode_SetFieldMask &=, query.c:1544);
    #   * no $params, no KNN/VECTOR_RANGE, no w'wildcards', no ismissing,
    #     no numeric operators, no GEOMETRY (all dialect >= 2);
    #   * `*` is only valid as the entire query (v1 `query ::= STAR`);
    #   * numeric endpoints lex differently: `.` and `+` are separators
    #     (`.1` = 1, `+.00` = 0), exponents reject `+` (`1e+3` errors)
    #     (v1 lexer.rl:35 number pattern);
    #   * unknown fields match nothing instead of erroring (grammar
    #     actions drop the node; resolved later in index.parse_query);
    #   * stray `}`/`]` are ignored (`@t:{x}}}}` parses).
    # Observable behaviors mirrored from the reference's own dialect suite
    # (tests/pytests/test_dialect.py test_v1_vs_v2).
    # ======================================================================

    def _parse_d1_query(self, cur: _Cursor) -> ast.Node:
        if cur.peek() == "*":
            save = cur.i
            cur.i += 1
            cur.skip_ws()
            if cur.eof():
                return ast.WildcardNode()
            cur.i = save  # *suffix / *infix* affix — fall through
        node = self._d1_chain(cur, stops="")
        cur.skip_ws()
        if not cur.eof():
            cur.error(f"unexpected trailing input {cur.s[cur.i:]!r}")
        if node is None:
            return ast.EmptyNode()
        return node

    def _d1_chain(self, cur: _Cursor, stops: str,
                  stop_minus: bool = False,
                  stop_tilde: bool = False) -> Optional[ast.Node]:
        """Parse an and/or chain.  `stops` are closing chars; stop_minus/
        stop_tilde end the chain *before* a -/~ (used for -/~ child scope
        per the v1 precedence table: MINUS(6) > TILDE(2), so `-` stops at
        both while `~` absorbs a following `-`)."""
        units: list[ast.Node] = []
        while True:
            cur.skip_ws()
            ch = cur.peek()
            if cur.eof() or (ch and ch in stops):
                break
            if ch in "}]":        # stray closers are punctuation in v1
                cur.i += 1
                continue
            if ch == "|":
                cur.i += 1
                rhs = self._d1_element(cur, stops)
                if not units:
                    if rhs is not None:
                        units.append(rhs)
                    continue
                lhs = units.pop()
                if rhs is None:
                    units.append(lhs)
                elif (isinstance(lhs, ast.UnionNode)
                      and lhs.fieldmask_attrs is None):
                    lhs.kids.append(rhs)
                    units.append(lhs)
                else:
                    units.append(ast.UnionNode(kids=[lhs, rhs]))
                continue
            if ch == "-" and stop_minus:
                break
            if ch == "~" and (stop_tilde or stop_minus):
                break
            before = cur.i
            node = self._d1_element(cur, stops)
            if node is not None:
                units.append(node)
            elif cur.i == before:
                cur.i += 1             # bare punctuation (e.g. `!`)
        if not units:
            return None
        if len(units) == 1:
            return units[0]
        return ast.IntersectNode(kids=units)

    def _d1_element(self, cur: _Cursor, stops: str) -> Optional[ast.Node]:
        """One chain element: termlist, -/~ clause, group, field scope,
        phrase, fuzzy, affix, or term; plus `=>{attrs}` suffixes."""
        cur.skip_ws()
        ch = cur.peek()
        if ch == "-":
            cur.i += 1
            child = self._d1_chain(cur, stops, stop_minus=True)
            # v1: MINUS over a NULL expr (e.g. stopword) is NULL
            return ast.NotNode(child=child) if child is not None else None
        if ch == "~":
            cur.i += 1
            child = self._d1_chain(cur, stops, stop_tilde=True)
            return (ast.OptionalNode(child=child)
                    if child is not None else None)
        node = self._d1_primary(cur, stops)
        if node is None:
            return None
        return self._d1_arrows(cur, node)

    def _d1_arrows(self, cur: _Cursor, node: ast.Node) -> ast.Node:
        cur.skip_ws()
        while cur.startswith("=>"):
            save = cur.i
            cur.i += 2
            cur.skip_ws()
            if cur.peek() == "{":
                self._parse_attrs(cur, node)
            elif cur.peek() == "[":
                cur.error("vector queries require DIALECT 2")
            else:
                cur.i = save
                break
            cur.skip_ws()
        return node

    def _d1_primary(self, cur: _Cursor, stops: str) -> Optional[ast.Node]:
        ch = cur.peek()
        if ch == "$":
            cur.error("$ parameters require DIALECT 2")
        if ch == "(":
            cur.i += 1
            cur.skip_ws()
            if cur.peek() == "*":      # v1: STAR only as the whole query
                save = cur.i
                cur.i += 1
                cur.skip_ws()
                if cur.peek() == ")":
                    cur.error("`*` is not a valid expression in DIALECT 1")
                cur.i = save
            inner = self._d1_chain(cur, stops=")")
            cur.skip_ws()
            cur.expect(")")
            return inner
        if ch == "*":
            # affix (*suffix / *infix*) is fine; bare star is not
            if cur.peek(1) and cur.peek(1) not in " \t\r\n)|=":
                return self._parse_affix(cur, None)
            cur.error("`*` is not a valid expression in DIALECT 1")
        if ch == "@":
            return self._d1_field(cur, stops)
        if ch == '"':
            txt = self._read_quoted(cur, '"')
            if "$" in txt:
                cur.error("$ parameters require DIALECT 2")
            return self._parse_exact_phrase_text(txt)
        if ch == "'":  # plain punctuation in v1 — skip
            cur.i += 1
            return None
        if ch == "%":
            return self._parse_fuzzy(cur)
        if ch in ")|":
            return None
        if ch in "}]":
            cur.i += 1
            return None
        return self._d1_termlist(cur)

    def _parse_exact_phrase_text(self, txt: str) -> ast.Node:
        toks = _split_terms(txt)
        kids = [ast.TokenNode(term=normalize_token(t), verbatim=True)
                for t in toks if normalize_token(t) not in self.stopwords]
        if not kids:
            return ast.EmptyNode()
        if len(kids) == 1:
            return kids[0]
        return ast.PhraseNode(terms=kids, exact=True, inorder=True)

    def _d1_termlist(self, cur: _Cursor) -> Optional[ast.Node]:
        """Consecutive bare terms fold into one phrase-intersection
        (v1 `termlist ::= term term ...`)."""
        kids: list[ast.Node] = []
        while True:
            cur.skip_ws()
            ch = cur.peek()
            if (cur.eof() or ch in "()|{}[]\"~-@:;*%$=" or ch in " \t"):
                break
            if ch == "'":
                cur.i += 1
                continue
            save = cur.i
            text = self._read_d1_term(cur)
            if not text:
                if not (ch.isalnum() or ch == "_" or ord(ch) > 127):
                    cur.i += 1     # plain punctuation separates terms
                    continue
                break
            if cur.peek() == "*":
                # prefix affix: a separate expr in v1 (not a termlist
                # member — PREFIX has its own token class, lexer.rl:56)
                if kids:
                    cur.i = save       # leave it for the outer chain
                    break
                cur.i += 1
                return ast.AffixNode(text=normalize_token(text),
                                     prefix=True, suffix=False)
            tok = self._token_or_none(text)
            if tok is not None:
                kids.append(tok)
        if not kids:
            return None
        if len(kids) == 1:
            return kids[0]
        return ast.IntersectNode(kids=kids)

    def _read_d1_term(self, cur: _Cursor) -> str:
        """v1 lexer term: ALL punctuation splits (lexer.rl:54 `term =
        any - punct ...`), except a number token `d+(.d+)?([eE]-?d+)?`
        lexes whole (longest match) — so `1.2e+3` yields 1.2 / e / 3."""
        import re
        m = re.compile(r"\d+(\.\d+)?([eE]-\d+|[eE]\d+)?").match(
            cur.s, cur.i)
        parts = []
        j = cur.i
        while j < cur.n:
            ch = cur.s[j]
            if ch == "\\" and j + 1 < cur.n:
                parts.append(cur.s[j + 1])
                j += 2
                continue
            if not (ch.isalnum() or ch == "_" or ord(ch) > 127):
                break
            parts.append(ch)
            j += 1
        if m is not None and m.end() > j:
            cur.i = m.end()
            return m.group(0)
        cur.i = j
        return "".join(parts)

    def _d1_field(self, cur: _Cursor, stops: str) -> Optional[ast.Node]:
        cur.expect("@")
        fields = [self._read_ident(cur)]
        while cur.peek() == "|":
            cur.i += 1
            if cur.peek() == "@":
                cur.i += 1
            fields.append(self._read_ident(cur))
        cur.skip_ws()
        if cur.peek() in "<>=!":
            cur.error("numeric operators require DIALECT 2")
        cur.expect(":")
        cur.skip_ws()
        ch = cur.peek()
        if ch == "{":
            node: ast.Node = self._parse_tag(cur, fields[0])
            # v1 tolerates trailing `}` garbage — the chain loop skips it
            node._d1_unknown_field_ok = True  # type: ignore[attr-defined]
            return node
        if ch == "[":
            return self._d1_bracket(cur, fields[0])
        scoped = self._d1_scoped(cur, stops)
        if scoped is None:
            cur.error(f"empty field scope for @{'|'.join(fields)}")
        return _d1_mask(scoped, fields)

    def _d1_scoped(self, cur: _Cursor, stops: str) -> Optional[ast.Node]:
        """The expression a v1 modifier captures: a termlist / single
        primary / nested scope / -/~ clause, then any `|` continuations
        (OR binds tighter than MODIFIER in the v1 precedence table)."""
        cur.skip_ws()
        ch = cur.peek()
        if ch == "-":
            cur.i += 1
            child = self._d1_scoped(cur, stops)
            return ast.NotNode(child=child) if child else None
        if ch == "~":
            cur.i += 1
            child = self._d1_scoped(cur, stops)
            return ast.OptionalNode(child=child) if child else None
        if ch == "@":
            first: Optional[ast.Node] = self._d1_field(cur, stops)
        elif ch == "(":
            first = self._d1_primary(cur, stops)
        elif ch == '"':
            first = self._d1_primary(cur, stops)
        elif ch == "%":
            first = self._parse_fuzzy(cur)
        elif ch == "*" and cur.peek(1) and cur.peek(1) not in " \t\r\n)|=":
            first = self._parse_affix(cur, None)
        elif ch == "$":
            cur.error("$ parameters require DIALECT 2")
        else:
            first = self._d1_termlist(cur)
        # union continuations
        while True:
            cur.skip_ws()
            if cur.peek() != "|":
                break
            cur.i += 1
            rhs = self._d1_scoped(cur, stops)
            if rhs is None:
                continue
            if first is None:
                first = rhs
            elif (isinstance(first, ast.UnionNode)
                  and first.fieldmask_attrs is None):
                first.kids.append(rhs)
            else:
                first = ast.UnionNode(kids=[first, rhs])
        return first

    def _d1_bracket(self, cur: _Cursor, field: str) -> ast.Node:
        """v1 `[...]`: numeric range (2 endpoints, legacy number lexing)
        or geo radius (4 args).  No GEOMETRY / VECTOR_RANGE."""
        cur.expect("[")
        save = cur.i
        toks: list[str] = []
        while True:
            cur.skip_ws()
            if cur.peek() == "]":
                cur.i += 1
                break
            if cur.eof():
                cur.error("unterminated [")
            toks.append(self._read_until(cur, " \t]"))
        up = toks[0].upper() if toks else ""
        if up in ("WITHIN", "CONTAINS", "INTERSECTS", "DISJOINT",
                  "VECTOR_RANGE"):
            cur.error(f"{up} requires DIALECT 2")
        if len(toks) == 4 and toks[3].lower() in ("m", "km", "mi", "ft"):
            try:
                lon = float(toks[0])
                lat = float(toks[1])
                radius = float(toks[2])
            except ValueError:
                cur.error("bad geo filter")
            node: ast.Node = ast.GeoNode(field=field, lon=lon, lat=lat,
                                         radius=radius,
                                         unit=toks[3].lower())
            node._d1_unknown_field_ok = True  # type: ignore[attr-defined]
            return node
        lo, lo_excl, hi, hi_excl = _d1_numeric_endpoints(toks, cur)
        if lo > hi:
            raise QuerySyntaxError(
                f"Invalid numeric range (min > max): "
                f"@{field}:[{lo:.6f} {hi:.6f}]")
        node = ast.NumericNode(field=field, lo=lo, hi=hi,
                               lo_excl=lo_excl, hi_excl=hi_excl)
        node._d1_unknown_field_ok = True  # type: ignore[attr-defined]
        return node


_D1_NUM_RE = None


def _d1_parse_number(tok: str):
    """One v1 numeric endpoint: lexer pattern
    `-? digit+ ('.' digit+)? ([eE] '-'? digit+)?` (v1 lexer.rl:35), with
    `+`/stray `.`/other punctuation acting as separators that are simply
    skipped.  Returns (value, exclusive) or None if the token is pure
    junk; raises QuerySyntaxError on a malformed number."""
    import re
    global _D1_NUM_RE
    if _D1_NUM_RE is None:
        _D1_NUM_RE = re.compile(r"\d+(\.\d+)?([eE]-\d+|[eE]\d+)?")
    excl = False
    s = tok
    if s.startswith("("):
        excl = True
        s = s[1:]
    sign = 1.0
    # strip separator punctuation (junk chars, leading dots, plus signs)
    while s and s[0] in "+.#$^&,":
        s = s[1:]
    if s.startswith("-"):
        sign = -1.0
        s = s[1:]
        while s and s[0] in "+.#$^&,":
            s = s[1:]
    if not s:
        return None if not excl else (None, True)
    low = s.lower()
    if low in ("inf", "infinity"):
        return (sign * math.inf, excl)
    m = _D1_NUM_RE.match(s)
    if m is None or m.end() != len(s):
        # trailing garbage that is pure punctuation is ok (e.g. "1.")
        if m is not None and all(c in ".#$^&,+" for c in s[m.end():]):
            return (sign * float(m.group(0)), excl)
        raise QuerySyntaxError(f"Syntax error: bad numeric value {tok!r}")
    return (sign * float(m.group(0)), excl)


def _d1_numeric_endpoints(toks: list[str], cur: _Cursor):
    vals = []
    for t in toks:
        if not t:
            continue
        got = _d1_parse_number(t)
        if got is None:
            continue
        if got[0] is None:   # lone "(" — exclusivity rides to next token
            if vals and vals[-1][0] is None:
                continue
            vals.append(got)
            continue
        if vals and vals[-1][0] is None:
            vals[-1] = (got[0], True)
        else:
            vals.append(got)
    vals = [v for v in vals if v[0] is not None]
    if len(vals) != 2:
        cur.error(f"bad numeric range {toks}")
    (lo, lo_excl), (hi, hi_excl) = vals
    return lo, lo_excl, hi, hi_excl


def _d1_mask(node: ast.Node, fields: list[str]) -> ast.Node:
    """v1 QueryNode_SetFieldMask (query.c:1544): mask &= new recursively.
    An empty intersection means the node can never match (@NULL)."""
    if isinstance(node, (ast.TagNode, ast.NumericNode, ast.GeoNode)):
        return node  # non-text nodes carry their own field
    if node.fieldmask_attrs is None:
        node.fieldmask_attrs = list(fields)
    else:
        node.fieldmask_attrs = [f for f in node.fieldmask_attrs
                                if f in fields]
        if not node.fieldmask_attrs:
            return ast.EmptyNode()
    for c in list(node.children()):
        masked = _d1_mask(c, fields)
        if masked is not c:
            _replace_child(node, c, masked)
    return node


def _replace_child(parent: ast.Node, old: ast.Node, new: ast.Node):
    for attr in ("kids", "terms"):
        lst = getattr(parent, attr, None)
        if isinstance(lst, list):
            for i, x in enumerate(lst):
                if x is old:
                    lst[i] = new
                    return
    if getattr(parent, "child", None) is old:
        parent.child = new


def _apply_fieldmask(node: ast.Node, fields: list[str]):
    """Scope a subtree to a field list (does not override inner scopes)."""
    if node.fieldmask_attrs is None:
        node.fieldmask_attrs = list(fields)
    if isinstance(node, ast.TagNode) or isinstance(node, ast.VectorNode):
        return
    for c in node.children():
        _apply_fieldmask(c, fields)


def _split_terms(text: str) -> list[str]:
    out = []
    cur: list[str] = []
    i = 0
    while i < len(text):
        ch = text[i]
        if ch == "\\" and i + 1 < len(text):
            cur.append(text[i + 1])
            i += 2
            continue
        if ch.isalnum() or ch == "_" or ord(ch) > 127:
            cur.append(ch)
        else:
            if cur:
                out.append("".join(cur))
                cur = []
        i += 1
    if cur:
        out.append("".join(cur))
    return out


def _coerce_vector(val: Any):
    """Normalize a vector param: bytes stay raw (decoded against the
    field's storage dtype at lowering — engine.decode_blob), numeric
    sequences become float arrays."""
    if isinstance(val, str):
        # RESP clients pass binary blobs as binary-safe strings
        return val.encode("latin-1", "surrogateescape")
    if isinstance(val, (bytes, bytearray)):
        return bytes(val)
    return np.asarray(val, dtype=np.float32).reshape(-1)

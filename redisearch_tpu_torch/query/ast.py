# Copy of redisearch_tpu/query/ast.py: the port imports nothing of the JAX package.
"""Query AST node types.

Reference: QueryNode (src/query_node.h) — node kinds TOKEN, PHRASE, UNION,
NOT, OPTIONAL, NUMERIC, GEO, GEOMETRY, PREFIX(+suffix/contains), FUZZY, TAG,
IDS, WILDCARD(*), WILDCARD_QUERY, VECTOR, MISSING, NULL; per-node attributes
weight/slop/inorder/phonetic ($weight/$slop/$inorder => {...} syntax).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional


@dataclasses.dataclass
class Node:
    """Base query node.  `fieldmask_attrs` is the list of TEXT field
    attributes this subtree is scoped to (None = all fields)."""

    weight: float = 1.0
    fieldmask_attrs: Optional[list[str]] = None

    def children(self) -> list["Node"]:
        return []


@dataclasses.dataclass
class TokenNode(Node):
    term: str = ""
    verbatim: bool = False    # no stem/synonym/phonetic expansion
    # expansions filled by the expander: list of (term, kind) where kind is
    # "self" | "stem" | "synonym" | "phonetic"
    expansions: Optional[list[str]] = None


@dataclasses.dataclass
class PhraseNode(Node):
    terms: list[Node] = dataclasses.field(default_factory=list)
    exact: bool = False
    slop: int = 0
    inorder: bool = False

    def children(self):
        return self.terms


@dataclasses.dataclass
class IntersectNode(Node):
    kids: list[Node] = dataclasses.field(default_factory=list)

    def children(self):
        return self.kids


@dataclasses.dataclass
class UnionNode(Node):
    kids: list[Node] = dataclasses.field(default_factory=list)

    def children(self):
        return self.kids


@dataclasses.dataclass
class NotNode(Node):
    child: Optional[Node] = None

    def children(self):
        return [self.child] if self.child else []


@dataclasses.dataclass
class OptionalNode(Node):
    child: Optional[Node] = None

    def children(self):
        return [self.child] if self.child else []


@dataclasses.dataclass
class AffixNode(Node):
    """prefix* / *suffix / *infix* (reference: QN_PREFIX with flags)."""

    text: str = ""
    prefix: bool = False    # pattern ends with *
    suffix: bool = False    # pattern starts with *


@dataclasses.dataclass
class FuzzyNode(Node):
    term: str = ""
    max_dist: int = 1       # %term% = 1, %%term%% = 2, %%%term%%% = 3


@dataclasses.dataclass
class WildcardQueryNode(Node):
    """w'pat*ern?' glob match over the term dict (QN_WILDCARD_QUERY)."""

    pattern: str = ""


@dataclasses.dataclass
class TagNode(Node):
    field: str = ""
    # each child is TokenNode (exact value), AffixNode, WildcardQueryNode
    # or FuzzyNode evaluated against the tag-value dictionary
    kids: list[Node] = dataclasses.field(default_factory=list)

    def children(self):
        return self.kids


@dataclasses.dataclass
class NumericNode(Node):
    field: str = ""
    lo: float = -math.inf
    hi: float = math.inf
    lo_excl: bool = False
    hi_excl: bool = False


@dataclasses.dataclass
class GeoNode(Node):
    field: str = ""
    lon: float = 0.0
    lat: float = 0.0
    radius: float = 0.0
    unit: str = "m"         # m | km | mi | ft


@dataclasses.dataclass
class GeometryNode(Node):
    field: str = ""
    predicate: str = "WITHIN"   # WITHIN/CONTAINS/INTERSECTS/DISJOINT
    wkt: str = ""


@dataclasses.dataclass
class VectorNode(Node):
    """KNN or range vector query (QN_VECTOR, src/query.c:809)."""

    field: str = ""
    mode: str = "KNN"           # KNN | RANGE
    blob: Any = None            # query vector (np array)
    blob_param: Optional[str] = None  # $param name (prepared-query reuse)
    k: int = 10
    radius: float = 0.0
    child: Optional[Node] = None   # prefilter ((expr)=>[KNN ...])
    score_alias: Optional[str] = None  # AS name
    ef_runtime: Optional[int] = None
    batch_size: Optional[int] = None
    hybrid_policy: Optional[str] = None  # BATCHES | ADHOC_BF
    epsilon: Optional[float] = None

    def children(self):
        return [self.child] if self.child else []


@dataclasses.dataclass
class IdsNode(Node):
    """Internal: explicit doc key list (QN_IDS)."""

    keys: list[str] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class WildcardNode(Node):
    """`*` — match all docs (QN_WILDCARD)."""


@dataclasses.dataclass
class MissingNode(Node):
    """ismissing(@field) — docs lacking the field (QN_MISSING)."""

    field: str = ""


@dataclasses.dataclass
class EmptyNode(Node):
    """Matches nothing (QN_NULL), e.g. stopword-only queries."""


def walk(node: Node):
    yield node
    for c in node.children():
        yield from walk(c)


def dump(node: Node, depth: int = 0) -> str:
    """EXPLAIN-style tree dump (reference: FT.EXPLAIN output shape)."""
    pad = "  " * depth
    t = type(node).__name__.replace("Node", "").upper()
    extra = ""
    if isinstance(node, TokenNode):
        extra = f" {node.term!r}"
        if node.expansions:
            extra += f" -> {node.expansions}"
    elif isinstance(node, AffixNode):
        star_l = "*" if node.suffix else ""
        star_r = "*" if node.prefix else ""
        extra = f" {star_l}{node.text}{star_r}"
    elif isinstance(node, FuzzyNode):
        extra = f" %{node.term}% dist={node.max_dist}"
    elif isinstance(node, WildcardQueryNode):
        extra = f" w'{node.pattern}'"
    elif isinstance(node, NumericNode):
        extra = (f" @{node.field}:[{'(' if node.lo_excl else ''}{node.lo} "
                 f"{'(' if node.hi_excl else ''}{node.hi}]")
    elif isinstance(node, TagNode):
        extra = f" @{node.field}"
    elif isinstance(node, GeoNode):
        extra = f" @{node.field}:[{node.lon} {node.lat} {node.radius} {node.unit}]"
    elif isinstance(node, GeometryNode):
        extra = f" @{node.field} {node.predicate}"
    elif isinstance(node, VectorNode):
        extra = f" @{node.field} {node.mode} k={node.k}"
    elif isinstance(node, MissingNode):
        extra = f" ismissing(@{node.field})"
    elif isinstance(node, PhraseNode):
        extra = f" exact={node.exact} slop={node.slop} inorder={node.inorder}"
    if node.fieldmask_attrs:
        extra += f" fields={node.fieldmask_attrs}"
    if node.weight != 1.0:
        extra += f" w={node.weight}"
    lines = [f"{pad}{t}{extra}"]
    for c in node.children():
        lines.append(dump(c, depth + 1))
    return "\n".join(lines)

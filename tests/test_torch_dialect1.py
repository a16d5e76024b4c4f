"""Dialect-1 (legacy grammar) emulation tests.

Mirrors the reference's own dialect suite
(tests/pytests/test_dialect.py test_v1_vs_v2 + test_dialect_aggregate +
test_dialect1_filter_on_nonexistent_field); the grammar spec is
src/query_parser/v1/parser.y + lexer.rl.

Parity file of tests/test_dialect1.py (tests/torch_parity.py): each case runs
on the JAX package, then on the port (`Client(device="cpu")`), must
pass its own assertions on both, and the results of the calls it
makes must be equal: ids, totals, tie order and strings exactly,
scores within rtol 1e-5, atol 1e-6; profile times and INFO byte
sizes are not compared.
"""

from tests.torch_parity import parity, per_side, resolve, rs
import pytest

Client = rs.api.Client
ast = rs.query.ast
QueryParser = rs.query.parser.QueryParser
Field = rs.schema.Field
FieldType = rs.schema.FieldType
FieldNotFound = rs.utils.errors.FieldNotFound
QuerySyntaxError = rs.utils.errors.QuerySyntaxError
RSError = rs.utils.errors.RSError


def p1(q):
    return QueryParser(dialect=1).parse(q)


def is_err(q):
    with pytest.raises(resolve(QuerySyntaxError)):
        p1(q)


class TestD1Parser:
    @parity
    def test_dialect2_only_syntax_rejected(self):
        is_err("(*)")              # STAR only as the whole query in v1
        is_err("$hello")           # params are dialect >= 2
        is_err('"$hello"')
        is_err("*=>[KNN 10 @v $B]")
        is_err("@num>5")           # numeric operators are dialect >= 2
        is_err("*-*")

    @parity
    def test_nested_modifiers_intersect_masks(self):
        # v1 QueryNode_SetFieldMask &= (query.c:1544): disjoint masks -> @NULL
        assert isinstance(p1("@t1:@t2:@t3:hello"), ast.EmptyNode)
        # non-text nodes keep their own field
        n = p1("@title:@num:[0 10]")
        assert isinstance(n, ast.NumericNode)
        assert n.lo == 0 and n.hi == 10

    @parity
    def test_termlist_scope(self):
        # modifiers absorb the whole run of consecutive terms
        n = p1("@t1:James Brown")
        assert isinstance(n, ast.IntersectNode)
        assert all(k.fieldmask_attrs == ["t1"] for k in n.kids)
        # ... but an affix is a separate expr (PREFIX is its own token)
        n = p1("@t:foo ba*")
        assert n.kids[0].fieldmask_attrs == ["t"]
        assert n.kids[1].fieldmask_attrs is None
        # unions bind tighter than the modifier
        n = p1("@t:foo|bar")
        assert isinstance(n, ast.UnionNode)
        assert n.fieldmask_attrs == ["t"]

    @parity
    def test_union_takes_whole_termlist(self):
        # `a b|c` = (a b)|c in v1 (union's left arm is the termlist)
        n = p1("hello world | goodbye")
        assert isinstance(n, ast.UnionNode)
        assert isinstance(n.kids[0], ast.IntersectNode)

    @parity
    def test_minus_tilde_absorb(self):
        # MINUS/TILDE absorb the following chain (v1 precedence)
        n = p1("-hello world")
        assert isinstance(n, ast.NotNode)
        assert isinstance(n.child, ast.IntersectNode)
        # `-` stops at `~` (MINUS(6) > TILDE(2)); `~` absorbs a `-`
        n = p1("-foo ~bar")
        assert isinstance(n, ast.IntersectNode)
        assert isinstance(n.kids[0], ast.NotNode)
        assert isinstance(n.kids[1], ast.OptionalNode)
        assert isinstance(p1("~foo -bar"), ast.OptionalNode)

    @parity
    def test_legacy_number_lexing(self):
        # v1 lexer.rl:35 — `.`/`+` are separators, exponents reject `+`
        assert p1("@num:[0 .1]").hi == 1.0
        assert p1("@num:[0 .1e1]").hi == 10.0
        assert abs(p1("@num:[0 .1e-1]").hi - 0.1) < 1e-12
        is_err("@num:[0 .1e+1]")
        is_err("@num:[1e 0]")
        is_err("@num:[1.e1 1.e2]")
        assert p1("@num:[0 1.]").hi == 1.0
        assert p1("@num:[-.1e1 0]").lo == -10.0
        n = p1("@num:[-inf inf]")
        assert n.lo == float("-inf") and n.hi == float("inf")
        # junk tokens are skipped (MOD-6933 behavior)
        assert p1("@num:[0 . 1]").hi == 1.0
        assert p1("@num:[0 #$^ 1]").hi == 1.0
        with pytest.raises(resolve(QuerySyntaxError), match="min > max"):
            p1("@num:[-0.02 -.01]")
        n = p1("@num:[(1 (5]")
        assert n.lo_excl and n.hi_excl

    @parity
    def test_misc_v1_shapes(self):
        assert isinstance(p1("@title:{foo}}}}}"), ast.TagNode)
        assert isinstance(p1("w'abc?'"), (ast.IntersectNode, ast.TokenNode))
        n = p1("*1*")
        assert isinstance(n, ast.AffixNode) and n.prefix and n.suffix
        assert isinstance(p1("abc!"), ast.TokenNode)
        # free text splits numbers on `+`: 1.2e+3 -> 1.2 / e / 3
        n = p1("1.2e+3")
        assert [k.term for k in n.kids] == ["1.2", "e", "3"]
        assert isinstance(p1("*"), ast.WildcardNode)


class TestD1Engine:
    @pytest.fixture()
    def client(self):
        return per_side(lambda: self._client_make())

    def _client_make(self):
        c = Client()
        c.ft_create("idx", [Field("t1", FieldType.TEXT),
                            Field("t2", FieldType.TEXT),
                            Field("num", FieldType.NUMERIC)])
        c.hset("h1", {"t1": "James Brown", "t2": "Jimi Hendrix", "num": 1})
        c.hset("h2", {"t1": "James", "t2": "Brown", "num": 2})
        return c

    @parity
    def test_scope_difference_vs_dialect2(self, client):
        # reference test_dialect_aggregate: D1 scopes both terms to t1
        r1 = client.ft_search("idx", "@t1:James Brown", dialect=1,
                              no_content=True)
        r2 = client.ft_search("idx", "@t1:James Brown", dialect=2,
                              no_content=True)
        assert r1.total == 1 and r1.hits[0].key == "h1"
        assert r2.total == 2

    @parity
    def test_unknown_fields_match_nothing(self, client):
        for q in ("@nonexistent:[0 10]", "@nonexistent:{value}",
                  "@bad:hello", "@t1:@t2:james"):
            r = client.ft_search("idx", q, dialect=1, no_content=True)
            assert r.total == 0, q
        with pytest.raises(resolve(FieldNotFound)):
            client.ft_search("idx", "@nonexistent:[0 10]", dialect=2)

    @parity
    def test_legacy_filter_args(self, client):
        r = client.ft_search("idx", "*",
                             filters=[("numeric", "num", "0", "1")],
                             no_content=True)
        assert r.total == 1 and r.hits[0].key == "h1"
        # nonexistent field under dialect 1 -> empty, not an error
        r = client.ft_search("idx", "*", dialect=1, no_content=True,
                             filters=[("numeric", "nonexistent", "0", "10")])
        assert r.total == 0
        r = client.ft_search(
            "idx", "*", dialect=1, no_content=True,
            filters=[("geo", "nonexistent", "0", "0", "100", "km")])
        assert r.total == 0

    @parity
    def test_dialect_validation(self, client):
        with pytest.raises(resolve(RSError)):
            client.ft_search("idx", "*", dialect=6)
        with pytest.raises(resolve(RSError)):
            client.ft_search("idx", "*", dialect=0)

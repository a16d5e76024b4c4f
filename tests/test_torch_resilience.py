"""Failure handling: timeouts, OOM policies, indexing errors, warnings
(reference: SURVEY.md §5.3 — timeout policies, OOM guardrail, index
errors with per-field attribution).

Parity file of tests/test_resilience.py (tests/torch_parity.py): each case runs
on the JAX package, then on the port (`Client(device="cpu")`), must
pass its own assertions on both, and the results of the calls it
makes must be equal: ids, totals, tie order and strings exactly,
scores within rtol 1e-5, atol 1e-6; profile times and INFO byte
sizes are not compared.  The OOM cases patch `torch.cuda.mem_get_info` on
the port's side where the JAX package's read `jax.devices`.
"""

from tests.torch_parity import parity, resolve, rs, side, unwrap
import pytest
import torch


def _small_index():
    ix = rs.SearchIndex(rs.Schema(name="r", fields=[
        rs.Field("t", rs.FieldType.TEXT),
        rs.Field("n", rs.FieldType.NUMERIC)]))
    for i in range(20):
        ix.add_document(f"d{i}", {"t": f"tok{i % 3}", "n": i})
    ix.commit()
    return ix


@parity
def test_indexing_error_recorded_and_skipped():
    ix = _small_index()
    ix.add_document("bad", {"t": "fine", "n": "not-a-number"})
    ix.add_document("good", {"t": "fine", "n": 5})
    ix.commit()
    assert ix.index_errors["count"] == 1
    assert ix.index_errors["last_error_key"] == "bad"
    assert "bad" not in ix.doctable
    res = ix.search("fine")
    assert {h.key for h in res} == {"good"}
    info = ix.info()
    assert info["index_errors"]["count"] == 1


@parity
def test_timeout_fail_policy():
    ix = _small_index()
    ix.timeout_ms = 0.000001  # immediately elapsed
    ix.on_timeout = "fail"
    # force a deadline in the past by monkeypatching the knob after commit
    ix.timeout_ms = 1e-9
    with pytest.raises(resolve(rs.errors.TimeoutError_)):
        # deadline check happens before the first segment executes
        import time
        ix.timeout_ms = 1e-12
        time.sleep(0.001)
        ix.search("tok1")


@parity
def test_timeout_return_policy_partial():
    ix = _small_index()
    ix.timeout_ms = 1e-12
    ix.on_timeout = "return"
    res = ix.search("tok1")
    assert "Timeout limit was reached" in res.warnings
    assert res.total == 0  # no segment executed before the deadline


def _memory_in_use(monkeypatch, ix, in_use, limit):
    """Device memory `in_use` of `limit` as each package reads it: the
    JAX package's `jax.devices()[0].memory_stats()`, the port's
    `torch.cuda.mem_get_info` of the index's card (the port asks only
    for an index on a card, so the index is told it is on one; the
    guard answers before the query touches the device)."""
    if side() == "jax":
        class FakeDev:
            def memory_stats(self):
                return {"bytes_in_use": in_use, "bytes_limit": limit}

        import jax
        monkeypatch.setattr(jax, "devices", lambda *a: [FakeDev()])
    else:
        monkeypatch.setattr(torch.cuda, "mem_get_info",
                            lambda *a: (limit - in_use, limit))
        unwrap(ix).device = torch.device("cuda", 0)


@parity
def test_oom_return_policy(monkeypatch):
    ix = _small_index()
    ix.on_oom = "return"

    _memory_in_use(monkeypatch, ix, 95, 100)
    res = ix.search("tok1")
    assert res.total == 0
    assert any("OOM" in w for w in res.warnings)


@parity
def test_oom_fail_policy(monkeypatch):
    ix = _small_index()
    ix.on_oom = "fail"

    _memory_in_use(monkeypatch, ix, 99, 100)
    with pytest.raises(resolve(rs.errors.IndexError_)):
        ix.search("tok1")


@parity
def test_info_has_sections():
    ix = _small_index()
    info = ix.info()
    for key in ("index_name", "num_docs", "num_terms", "num_records",
                "inverted_sz_mb", "vector_index_sz_mb", "attributes",
                "index_errors", "index_options"):
        assert key in info, key


@parity
def test_obfuscation_hide_user_data():
    """hide-user-data-from-log (reference: src/obfuscation/) — index/doc
    names become stable handles in logs and in the Index Errors section."""
    Client = rs.api.Client
    Field = rs.schema.Field
    FieldType = rs.schema.FieldType
    _log = rs.utils.log

    c = Client()
    c.ft_config_set("HIDE_USER_DATA_FROM_LOG", "true")
    try:
        c.ft_create("private_idx", [Field("n", FieldType.NUMERIC)])
        c.hset("secret_doc", {"n": "not-a-number"})
        info = c.ft_info("private_idx")
        assert info["index_errors"]["count"] == 1
        assert info["index_errors"]["last_error_key"].startswith("Document@")
        assert _log.obfuscate_index("private_idx").startswith("Index@")
        # flipping the flag restores raw names (both are retained)
        c.ft_config_set("HIDE_USER_DATA_FROM_LOG", "false")
        info = c.ft_info("private_idx")
        assert info["index_errors"]["last_error_key"] == "secret_doc"
    finally:
        c.ft_config_set("HIDE_USER_DATA_FROM_LOG", "false")


@parity
def test_debug_fault_injection():
    """_FT.DEBUG query wrapping (reference: aggregate_debug.c
    TIMEOUT_AFTER_N / CRASH / PAUSE + debug RPs): deterministic timeouts
    and crashes for tests."""
    import pytest as _pytest
    Client = rs.api.Client
    Field = rs.schema.Field
    FieldType = rs.schema.FieldType

    c = Client()
    c.ft_create("dbg", [Field("t", FieldType.TEXT)])
    for i in range(20):
        c.hset(f"d{i}", {"t": "common words here"})
    ix = c._index("dbg")

    # TIMEOUT_AFTER_N: partial results + warning (ON_TIMEOUT=return)
    ix.set_debug_hooks(timeout_after_n=5)
    r = c.ft_search("dbg", "common", num=100, no_content=True)
    assert len(r.hits) == 5
    assert "Timeout limit was reached" in r.warnings

    # ON_TIMEOUT=fail -> raises
    TimeoutError_ = rs.utils.errors.TimeoutError_
    c.ft_config_set("ON_TIMEOUT", "fail")
    ix.set_debug_hooks(timeout_after_n=5)
    with _pytest.raises(resolve(TimeoutError_)):
        c.ft_search("dbg", "common", num=100)
    c.ft_config_set("ON_TIMEOUT", "return")

    # hooks are one-shot
    r = c.ft_search("dbg", "common", num=100, no_content=True)
    assert len(r.hits) == 20 and not r.warnings

    # CRASH
    ix.set_debug_hooks(crash=True)
    with _pytest.raises(resolve(RuntimeError), match="Debug crash"):
        c.ft_search("dbg", "common")

    # aggregate timeout injection
    AggregateRequest = rs.agg.pipeline.AggregateRequest
    ix.set_debug_hooks(timeout_after_n=3)
    res = c.ft_aggregate("dbg", AggregateRequest("common").load("t"))
    assert len(res.rows) == 3
    assert res.warnings == ["Timeout limit was reached"]


@parity
def test_background_initial_scan():
    """FT.CREATE with a background scan indexes existing keys on a thread;
    FT.INFO exposes indexing/percent_indexed while it runs (reference:
    indexes_scanner.c scanned/total surfaced in info)."""
    Client = rs.api.Client
    Field = rs.schema.Field
    FieldType = rs.schema.FieldType

    c = Client()
    for i in range(200):
        c.hset(f"doc{i}", {"t": f"common word{i % 5}"})
    ix = c.ft_create("bg", [Field("t", FieldType.TEXT)],
                     background_scan=True)
    assert ix.wait_scan(timeout=60.0)
    info = c.ft_info("bg")
    assert info["indexing"] == 0
    assert info["percent_indexed"] == 1.0
    assert info["background_indexing_status"] == "OK"
    r = c.ft_search("bg", "common", no_content=True)
    assert r.total == 200

    # synchronous create reports no scan state at all
    c2 = Client()
    c2.hset("a", {"t": "x y"})
    c2.ft_create("sync", [Field("t", FieldType.TEXT)])
    info2 = c2.ft_info("sync")
    assert info2["indexing"] == 0 and info2["percent_indexed"] == 1.0


@parity
def test_compile_time_not_charged_to_timeout():
    """First use of a query shape XLA-compiles (seconds); that one-time
    cost must not burn the query timeout budget and truncate segment
    iteration (reference: timeouts clock query execution, not setup)."""
    Client = rs.api.Client
    Field = rs.schema.Field
    FieldType = rs.schema.FieldType

    c = Client()
    c.ft_create("ct", [Field("t", FieldType.TEXT)])
    for i in range(30):
        c.hset(f"k{i}", {"t": f"shared tok{i % 7}"})
    c.ft_search("ct", "shared", no_content=True)   # seals segment 1
    c.hset("k999", {"t": "shared fresh"})          # -> segment 2
    ix = c._index("ct")
    ix.timeout_ms = 50   # far below one compile, far above one execute
    res = ix.search("fresh")                       # new shape: compiles
    assert res.total == 1, (res.total, res.warnings)
    assert not res.warnings

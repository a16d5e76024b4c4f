"""Run a JAX test file's cases through both packages and compare what
they return.

The parity files `tests/test_torch_{client,scorers,dialect1,resilience,
reference_semantics,smoke,fuzz_aggregate,multivalue,prepared_aliasing,
fuzz_differential,fields,server,dist,dist_agg,fuzz_dist}.py` are the
JAX package's test files with their imports pointed here:

* `rs` names the package of the side that runs: `rs.Client`,
  `rs.FieldType.TEXT`, `rs.query.engine.execute` resolve in
  `redisearch_tpu` or in `redisearch_tpu_torch` when they are used, so a
  module-level `Field = rs.Field` stays late until a test runs.  On the
  port's side `rs.Client()` and `rs.SearchIndex(schema)` are on the CPU
  (`device="cpu"`), as every port test runs.
* `@parity` runs a test body twice, first against the JAX package, then
  against the port; each run must pass the body's own assertions.
  Every call made on a `Client` or `SearchIndex` (and on module
  functions reached through `rs`) is recorded with its result, and the
  two records must be equal: totals, ids, tie order, strings (explain
  trees, highlights, suggestions, spellcheck terms, config values, INFO
  counts) exactly, floats within rtol 1e-5, atol 1e-6 (a number printed
  inside a string may also differ by one unit of its last digit; a
  hit's vector distance within atol 1e-5).
  Profile times and INFO byte sizes are not compared.
* `per_side(factory)` is a fixture's value: the factory runs once on
  each side, under that side's package.
* `shard(index, mesh)` builds the running side's `ShardedIndex`, whose
  calls are recorded as a `SearchIndex`'s are; on the port's side
  `rs.parallel.dist.make_mesh` makes CPU slots (`device="cpu"`).

Only the parity tests import both packages.
"""

from __future__ import annotations

import contextlib
import enum
import functools
import importlib
import math
import re
import types

import numpy as np

PACKAGES = {"jax": "redisearch_tpu", "torch": "redisearch_tpu_torch"}
RTOL, ATOL = 1e-5, 1e-6
# vector distances: the L2 form sq - 2 dot + qsq carries about 2e-6 of
# f32 rounding at unit-scale rows, summed in different orders by the
# two packages (the earlier parity files' 1e-5)
DIST_ATOL = 1e-5

_state = {"side": None, "log": None, "depth": 0}

# keys whose values differ between the packages by design: clocks and
# byte sizes (the port counts its own tensors)
_SKIP_KEY = re.compile(r"(_ms$|_sz_mb$|memory|bytes)")


def side() -> str | None:
    return _state["side"]


def _package():
    s = _state["side"]
    if s is None:
        raise RuntimeError("no side is running: use @parity")
    return importlib.import_module(PACKAGES[s])


def _walk(obj, name: str):
    try:
        return getattr(obj, name)
    except AttributeError:
        if isinstance(obj, types.ModuleType):
            return importlib.import_module(f"{obj.__name__}.{name}")
        raise


# ------------------------------------------------------------ late names
class Late:
    """A dotted name under the running side's package, resolved when it
    is used; outside a side, attribute access builds a longer Late."""

    def __init__(self, path: str = ""):
        object.__setattr__(self, "_path", path)

    def _resolve(self):
        obj = _package()
        for part in filter(None, self._path.split(".")):
            obj = _walk(obj, part)
        return _side_object(self._path, obj)

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        path = f"{self._path}.{name}" if self._path else name
        if _state["side"] is None:
            return Late(path)
        obj = _walk(self._resolve(), name)
        if isinstance(obj, types.ModuleType):
            return Late(path)
        return _side_object(path, obj)

    def __call__(self, *args, **kwargs):
        return self._resolve()(*args, **kwargs)

    def __repr__(self):
        return f"Late({self._path!r}, side={_state['side']})"


rs = Late()


def resolve(obj):
    """The object a Late names on the running side (other objects as
    they are): for `pytest.raises` and `isinstance`, which need a
    class."""
    return obj._resolve() if isinstance(obj, Late) else obj


def _side_object(path: str, obj):
    """The port's entry points on the CPU; module functions recorded."""
    if isinstance(obj, types.ModuleType):
        return obj
    if path in ("Client", "api.Client"):
        return _client_factory(obj)
    if path in ("SearchIndex", "index.index.SearchIndex"):
        return _index_factory(obj)
    if path in ("server.Server",):
        return _server_factory(obj)
    if path in ("aux.checkpoint.load", "parallel.dist.make_mesh"):
        return _recorded(_cpu_load(obj), path)
    if (callable(obj) and not isinstance(obj, type)
            and isinstance(obj, types.FunctionType)):
        return _recorded(obj, path)
    return obj


def _client_factory(cls):
    def make(*args, **kwargs):
        if _state["side"] == "torch":
            kwargs.setdefault("device", "cpu")
        return Proxy(cls(*args, **kwargs), "Client")
    return make


def _index_factory(cls):
    def make(*args, **kwargs):
        if _state["side"] == "torch":
            kwargs.setdefault("device", "cpu")
        return Proxy(cls(*args, **kwargs), "SearchIndex")
    return make


def _cpu_load(fn):
    @functools.wraps(fn)
    def load(*args, **kwargs):
        if _state["side"] == "torch":
            kwargs.setdefault("device", "cpu")
        return _wrap_result(fn(*args, **kwargs))
    return load


def shard(index, mesh=None):
    """`ShardedIndex.build` of the running side over an index (a Proxy
    or not), as a Proxy whose method calls are recorded."""
    dist = importlib.import_module(f"{PACKAGES[_state['side']]}"
                                   ".parallel.dist")
    return Proxy(dist.ShardedIndex.build(unwrap(index), mesh),
                 "ShardedIndex")


def _server_factory(cls):
    def make(*args, **kwargs):
        if kwargs.get("client") is None and not args:
            kwargs["client"] = unwrap(_client_factory(_package().Client)())
        return cls(*args, **kwargs)
    return make


# ------------------------------------------------------------ recording
def _record(entry) -> None:
    if _state["log"] is not None and _state["depth"] == 0:
        _state["log"].append(entry)


def _recorded(fn, name: str):
    @functools.wraps(fn)
    def call(*args, **kwargs):
        depth0 = _state["depth"]
        _state["depth"] = depth0 + 1
        try:
            out = fn(*args, **kwargs)
        except Exception as e:
            _state["depth"] = depth0
            _record((name, "raise", type(e).__name__))
            raise
        _state["depth"] = depth0
        _record((name, normalize(out)))
        return _wrap_result(out)
    return call


def _wrap_result(out):
    cls = type(out).__name__
    if cls in ("SearchIndex", "Client") and not isinstance(out, Proxy):
        return Proxy(out, cls)
    return out


class Proxy:
    """A Client or SearchIndex whose method calls are recorded."""

    def __init__(self, target, kind: str):
        object.__setattr__(self, "_target", target)
        object.__setattr__(self, "_kind", kind)

    def __getattr__(self, name):
        val = getattr(self._target, name)
        if callable(val) and isinstance(val, types.MethodType):
            return _recorded(val, f"{self._kind}.{name}")
        return val

    def __setattr__(self, name, value):
        setattr(self._target, name, value)

    def __len__(self):
        return len(self._target)

    def __repr__(self):
        return f"Proxy({self._target!r})"


def unwrap(obj):
    return obj._target if isinstance(obj, Proxy) else obj


def normalize(obj):
    """A comparable form of a result: plain Python values, results by
    their fields, other objects by their type's name."""
    if isinstance(obj, Proxy):
        obj = obj._target
    if obj is None or isinstance(obj, (bool, str, bytes)):
        return obj
    if isinstance(obj, (int, np.integer)):
        return int(obj)
    if isinstance(obj, (float, np.floating)):
        return float(obj)
    if isinstance(obj, enum.Enum):
        return normalize(obj.value)
    if isinstance(obj, np.ndarray):
        return normalize(obj.tolist())
    if type(obj).__module__.startswith("torch") and hasattr(obj, "tolist"):
        return normalize(obj.tolist())
    if isinstance(obj, dict):
        return {str(k): normalize(v) for k, v in obj.items()
                if not _SKIP_KEY.search(str(k))}
    if isinstance(obj, (list, tuple)):
        return [normalize(x) for x in obj]
    if isinstance(obj, (set, frozenset)):
        return sorted((normalize(x) for x in obj), key=repr)
    cls = type(obj).__name__
    if cls == "SearchResult":
        return {"SearchResult": True, "total": normalize(obj.total),
                "hits": [normalize(h) for h in obj.hits],
                "warnings": normalize(list(obj.warnings or []))}
    if cls == "Hit":
        return {"key": obj.key, "score": normalize(obj.score),
                "fields": normalize(obj.fields),
                "sortkey": normalize(obj.sortkey),
                "dist": normalize(obj.vector_distance),
                "payload": normalize(obj.payload)}
    if cls == "AggregateResult":
        return {"AggregateResult": True, "total": normalize(obj.total),
                "rows": normalize(obj.rows),
                "cursor_id": normalize(getattr(obj, "cursor_id", None)),
                "warnings": normalize(list(getattr(obj, "warnings", None)
                                           or []))}
    return f"<{cls}>"


_NUM = re.compile(r"-?\d+(?:\.\d+)?(?:[eE][-+]?\d+)?")


def _num_close(a: str, b: str) -> bool:
    x, y = float(a), float(b)
    if math.isclose(x, y, rel_tol=RTOL, abs_tol=ATOL):
        return True
    # one unit of the last printed digit (rounding at a boundary)
    dec = max(len(a.split(".")[1]) if "." in a and "e" not in a.lower()
              else 0,
              len(b.split(".")[1]) if "." in b and "e" not in b.lower()
              else 0)
    return dec > 0 and abs(x - y) <= 10.0 ** -dec * 1.0000001


def _str_close(a: str, b: str) -> bool:
    if a == b:
        return True
    na, nb = _NUM.findall(a), _NUM.findall(b)
    if len(na) != len(nb) or _NUM.sub("#", a) != _NUM.sub("#", b):
        return False
    return all(_num_close(x, y) for x, y in zip(na, nb))


def assert_same(j, t, where: str = "$") -> None:
    """Equal values: floats within RTOL/ATOL, strings exactly but for
    the numbers printed in them."""
    if isinstance(j, float) or isinstance(t, float):
        assert isinstance(j, (int, float)) and isinstance(t, (int, float)) \
            and not isinstance(j, bool) and not isinstance(t, bool), \
            (where, j, t)
        if math.isnan(j) or math.isnan(t):
            assert math.isnan(j) and math.isnan(t), (where, j, t)
            return
        atol = DIST_ATOL if where.endswith(".dist") else ATOL
        assert math.isclose(j, t, rel_tol=RTOL, abs_tol=atol) or j == t, \
            (where, j, t)
        return
    if isinstance(j, str) and isinstance(t, str):
        assert _str_close(j, t), (where, j, t)
        return
    if isinstance(j, dict) and isinstance(t, dict):
        assert sorted(j) == sorted(t), (where, sorted(j), sorted(t))
        for k in j:
            assert_same(j[k], t[k], f"{where}.{k}")
        return
    if isinstance(j, list) and isinstance(t, list):
        assert len(j) == len(t), (where, len(j), len(t), j, t)
        for i, (a, b) in enumerate(zip(j, t)):
            assert_same(a, b, f"{where}[{i}]")
        return
    assert j == t, (where, j, t)


@contextlib.contextmanager
def running(side_name: str, log: list):
    prev = dict(_state)
    _state.update(side=side_name, log=log, depth=0)
    try:
        yield
    finally:
        _state.update(prev)


def parity(fn):
    """Run the test body on the JAX package, then on the port; both
    must pass it, and their recorded calls must agree."""
    @functools.wraps(fn)
    def run(*args, **kwargs):
        logs = {}
        for s in ("jax", "torch"):
            logs[s] = []
            with running(s, logs[s]):
                fn(*args, **kwargs)
        assert len(logs["jax"]) == len(logs["torch"]), (
            [e[0] for e in logs["jax"]], [e[0] for e in logs["torch"]])
        for i, (a, b) in enumerate(zip(logs["jax"], logs["torch"])):
            assert a[0] == b[0], (i, a[0], b[0])
            assert_same(list(a[1:]), list(b[1:]), f"call {i} {a[0]}")
    return run


class per_side:
    """A fixture value made once on each side by `factory` and used as
    the object it made."""

    def __init__(self, factory):
        object.__setattr__(self, "_factory", factory)
        object.__setattr__(self, "_made", {})

    def _get(self):
        s = _state["side"]
        made = self._made
        if s not in made:
            made[s] = self._factory()
        return made[s]

    def __getattr__(self, name):
        return getattr(self._get(), name)

    def __iter__(self):             # fixtures that return tuples
        return iter(self._get())

    def __getitem__(self, key):
        return self._get()[key]


_MEM = re.compile(r"((?:memory|bytes)\w*:)\d+")


def wire(reply):
    """A comparable form of a RESP reply: profile clocks and byte counts
    replaced by "#" (in flat key, value lists, maps and INFO text)."""
    if isinstance(reply, str):
        return _MEM.sub(r"\1#", reply)
    if isinstance(reply, dict):
        return {k: ("#" if _SKIP_KEY.search(str(k)) else wire(v))
                for k, v in reply.items()}
    if isinstance(reply, list):
        out = []
        skip = False
        for x in reply:
            out.append("#" if skip else wire(x))
            skip = isinstance(x, str) and bool(_SKIP_KEY.search(x))
        return out
    return normalize(reply)


def record_reply(argv, reply) -> None:
    """Record one wire command's reply on the running side."""
    _record((f"wire {argv[0]}", wire(reply)))

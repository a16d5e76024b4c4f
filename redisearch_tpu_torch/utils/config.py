# Copy of redisearch_tpu/utils/config.py: the port imports nothing of the JAX package.
"""Runtime configuration registry (FT.CONFIG GET/SET / search-* configs).

Reference: src/config.c (RSConfigVar registry, ~80 params, defaults at
config.h:410).  The parameters kept here are the ones with behavioral
meaning in the TPU design; thread-pool/fork-GC knobs have no analog (the
segment model removes GC; intra-query parallelism is the device) and are
accepted read-only for compatibility, returning their reference defaults.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

from .errors import ConfigError


@dataclasses.dataclass
class _Var:
    name: str
    default: Any
    parse: Callable[[str], Any]
    settable: bool = True


def _bool(s) -> bool:
    if isinstance(s, bool):
        return s
    return str(s).lower() in ("true", "1", "yes")


_VARS = [
    _Var("TIMEOUT", 500, int),                      # query timeout ms
    _Var("ON_TIMEOUT", "return", str),              # return|fail
    _Var("MAXSEARCHRESULTS", 1_000_000, int),
    _Var("MAXAGGREGATERESULTS", -1, int),
    _Var("MAXPREFIXEXPANSIONS", 200, int),
    _Var("MINPREFIX", 2, int),
    _Var("MINSTEMLEN", 4, int),
    _Var("DEFAULT_DIALECT", 2, int),
    _Var("MAXDOCTABLESIZE", 1_000_000, int),
    _Var("MAXEXPANSIONS", 200, int),
    _Var("NOGC", False, _bool),
    _Var("GC_POLICY", "segment-compact", str, settable=False),
    _Var("FORK_GC_RUN_INTERVAL", 30, int, settable=False),
    _Var("WORKERS", 0, int, settable=False),        # device-parallel instead
    _Var("MT_MODE", "MT_MODE_OFF", str, settable=False),
    _Var("SEARCH_IO_THREADS", 1, int, settable=False),
    _Var("CURSOR_MAX_IDLE", 300_000, int),
    _Var("CURSOR_READ_SIZE", 1000, int),
    _Var("UNION_ITERATOR_HEAP", 20, int, settable=False),
    _Var("FRISOINI", "", str, settable=False),
    _Var("STOPWORDS", None, lambda s: s),
    _Var("DEFAULT_SCORER", "BM25STD", str),
    _Var("EXTLOAD", "", str, settable=False),
    _Var("VSS_MAX_RESIZE", 0, int),
    _Var("BM25STD_TANH_FACTOR", 4, int),
    _Var("_NUMERIC_COMPRESS", False, _bool),
    _Var("_FREE_RESOURCE_ON_THREAD", True, _bool, settable=False),
    _Var("RAW_DOCID_ENCODING", False, _bool, settable=False),
    _Var("OOM_SCORE_ADJ", False, _bool, settable=False),
    _Var("INDEX_CURSOR_LIMIT", 128, int),
    _Var("MEMORY_LIMIT_PCT", 80, int),              # OOM guardrail (ours)
    _Var("ON_OOM", "ignore", str),                  # ignore|return|fail
    _Var("KNN_BATCH_SIZE", 256, int),               # serving batch (ours)
    _Var("IVF_NPROBE", 8, int),                     # EF_RUNTIME analog
    _Var("TIERED_FLUSH_THRESHOLD", 1024, int),
    # privacy: obfuscate user data (index/field/doc names) in log lines
    # (reference: hide-user-data-from-log, src/obfuscation/)
    _Var("HIDE_USER_DATA_FROM_LOG", False, _bool),
    # --- remaining reference parameters (src/config.c registry), accepted
    # for compatibility.  Most tune machinery this design removed (fork-GC
    # cycles, background scanners, thread pools, coordinator connections) —
    # they are read-only and return the reference defaults.  The settable
    # ones feed the matching engine knobs where an analog exists.
    _Var("MIN_PHONETIC_TERM_LEN", 3, int),
    _Var("MAX_AGGREGATE_GROUPS", 0, int),           # 0 = unlimited
    _Var("MULTI_TEXT_SLOP", 100, int),
    _Var("PARTIAL_INDEXED_DOCS", False, _bool),
    _Var("UPGRADE_INDEX", "", str),
    _Var("GCSCANSIZE", 100, int, settable=False),
    _Var("FORK_GC_CLEAN_THRESHOLD", 100, int, settable=False),
    _Var("FORK_GC_RETRY_INTERVAL", 5, int, settable=False),
    _Var("FORKGC_SLEEP_BEFORE_EXIT", 0, int, settable=False),
    _Var("FORK_GC_CLEAN_NUMERIC_EMPTY_NODES", True, _bool,
         settable=False),
    _Var("_FORK_GC_CLEAN_NUMERIC_EMPTY_NODES", True, _bool,
         settable=False),
    _Var("BG_INDEX_SLEEP_DURATION_US", 0, int, settable=False),
    _Var("BG_INDEX_SLEEP_GAP", 100, int, settable=False),
    _Var("_BG_INDEX_MEM_PCT_THR", 0, int, settable=False),
    _Var("_BG_INDEX_OOM_PAUSE_TIME", 0, int, settable=False),
    _Var("INDEXER_YIELD_EVERY_OPS", 1000, int, settable=False),
    _Var("MIN_OPERATION_WORKERS", 4, int, settable=False),
    _Var("WORKER_THREADS", 0, int, settable=False),
    _Var("SEARCH_THREADS", 20, int, settable=False),
    _Var("WORKERS_PRIORITY_BIAS_THRESHOLD", 1, int, settable=False),
    _Var("PRIVILEGED_THREADS_NUM", 1, int, settable=False),
    _Var("CONN_PER_SHARD", 0, int, settable=False),
    _Var("CONNECT_TIMEOUT", 5, int, settable=False),
    _Var("TOPOLOGY_VALIDATION_TIMEOUT", 30_000, int, settable=False),
    _Var("CURSOR_REPLY_THRESHOLD", 1, int),
    _Var("TIERED_HNSW_BUFFER_LIMIT", 1024, int),
    _Var("ENABLE_UNSTABLE_FEATURES", False, _bool),
    _Var("NO_MEM_POOLS", False, _bool, settable=False),
    _Var("_MAX_FOREGROUND_TIMEOUT_LIMIT", 0, int, settable=False),
    _Var("_MAX_TRIM_DELAY_MS", 0, int, settable=False),
    _Var("_MIN_TRIM_DELAY_MS", 0, int, settable=False),
    _Var("_TRIMMING_STATE_CHECK_DELAY_MS", 0, int, settable=False),
    _Var("_NUMERIC_RANGES_PARENTS", 0, int),
    _Var("_PRINT_PROFILE_CLOCK", True, _bool),
    _Var("_PRIORITIZE_INTERSECT_UNION_CHILDREN", False, _bool),
    _Var("_SIMULATE_IN_FLEX", False, _bool, settable=False),
]


class Config:
    def __init__(self):
        self._vars = {v.name: v for v in _VARS}
        self._values = {v.name: v.default for v in _VARS}

    def get(self, name: str) -> Any:
        name = name.upper()
        if name == "*":
            return dict(self._values)
        if name not in self._values:
            raise ConfigError(f"Invalid option `{name}`")
        return self._values[name]

    def set(self, name: str, value: Any) -> None:
        name = name.upper()
        var = self._vars.get(name)
        if var is None:
            raise ConfigError(f"Invalid option `{name}`")
        if not var.settable:
            raise ConfigError(f"Not modifiable at runtime: `{name}`")
        self._values[name] = var.parse(value)
        if name == "HIDE_USER_DATA_FROM_LOG":
            from . import log as _log
            _log.set_hide_user_data(self._values[name])

    def __getitem__(self, name: str) -> Any:
        return self.get(name)

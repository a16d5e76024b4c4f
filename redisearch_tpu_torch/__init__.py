"""redisearch_tpu_torch — the search engine of `redisearch_tpu`, ported to
PyTorch and CUDA.

It keeps the JAX package's module names, imports torch and never jax,
and imports nothing of the JAX package: the host-only modules it needs
(schema, analysis, query parser, doc table, native tokenizer, aggregate
expressions and reducers) are copies of the JAX package's, each naming
its source in its first line.  Batched BM25 FT.SEARCH:
`Client.ft_search_many` -> `SearchIndex.search_many` ->
`query.engine.execute_batch` -> `ops.intersect.intersect_batch` (the CUDA
kernel `csrc/intersect.cu` on a card, its plain torch version on the
CPU); and batched FT.AGGREGATE GROUPBY: `Client.ft_aggregate_many` ->
`agg.pipeline.run_aggregate_many` -> the intersection kernel's raw mode
and `ops.groupby.groupby_aggregate_batch` (the CUDA kernel
`csrc/groupby.cu`).  FLAT vector search (`VectorParams`, KNN and
VECTOR_RANGE queries with PARAMS blobs) runs through `ops.vector` and the
engine's KNN executors; FT.HYBRID (`HybridQuery`, `Client.ft_hybrid`,
`run_hybrid_many`) fuses a text and a KNN branch; FT.AGGREGATE serves
every plan (the host pipeline where the device GROUPBY does not) and
WITHCURSOR.  Indexes take deletes, compact (`SearchIndex.compact`,
a CSR slice) and save to and load from checkpoints both packages read
(`Client.save_index`, `load_index`).  See ROADMAP.md for what is still
to port.
"""

from .schema import (Field, FieldType, Schema, VectorAlgo,
                     VectorMetric, VectorParams)
from .agg.pipeline import ASC, DESC, AggregateRequest, AggregateResult
from .aux.hybrid import HybridQuery, run_hybrid_many
from .api import Client
from .index.index import Hit, SearchIndex, SearchResult
from .query.engine import QueryOptions

__all__ = ["Schema", "Field", "FieldType", "VectorParams", "VectorAlgo",
           "VectorMetric", "QueryOptions", "SearchIndex",
           "SearchResult", "Hit", "Client", "AggregateRequest",
           "AggregateResult", "ASC", "DESC", "HybridQuery",
           "run_hybrid_many"]

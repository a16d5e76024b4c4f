# Copy of redisearch_tpu/schema.py: the port imports nothing of the JAX package.
"""Schema types: fields, index options, and the index spec.

TPU-native analog of the reference's IndexSpec / FieldSpec
(reference: src/spec.h:297-357, src/field_spec.h:31-39, src/spec.c:1073-1113).

Design notes (not a port):
  * The reference stores postings with per-index codec selection driven by
    NOOFFSETS/NOFREQS/... flags (src/spec.c:1703-1707).  Here those flags
    simply control which device-resident arrays a sealed segment carries
    (positions CSR, freq array, field-mask array) — there is no byte-level
    codec because postings live as fixed-stride int32 device arrays.
  * SORTABLE on TPU is the *default* cheap path for NUMERIC/TAG/GEO: every
    such field materializes a dense per-doc column, which is what the
    vectorized filter/sort kernels consume.  The flag is kept for API parity.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Sequence

from .utils.errors import FieldNotFound, IndexError_


class FieldType(enum.Enum):
    """Reference: FieldType enum, src/field_spec.h:31-39."""

    TEXT = "TEXT"
    NUMERIC = "NUMERIC"
    TAG = "TAG"
    GEO = "GEO"
    VECTOR = "VECTOR"
    GEOMETRY = "GEOMETRY"


class VectorAlgo(enum.Enum):
    """Reference: VecSimAlgo, src/vector_index.h:17-71.

    FLAT   — brute-force MXU distance scan (exact).
    IVF    — partitioned index with centroid routing; the TPU-native
             replacement for HNSW-recall-at-equal-memory (SURVEY §7.1).
    TIERED — append buffer + periodic recluster into IVF.
    HNSW is accepted as an alias for IVF so reference configs load unchanged.
    """

    FLAT = "FLAT"
    IVF = "IVF"
    TIERED = "TIERED"


class VectorMetric(enum.Enum):
    L2 = "L2"
    IP = "IP"
    COSINE = "COSINE"


#: Vector value dtypes supported (reference: VecSimType, 6 dtypes).
VECTOR_DTYPES = ("FLOAT32", "FLOAT64", "FLOAT16", "BFLOAT16", "INT8", "UINT8")


@dataclasses.dataclass
class VectorParams:
    """KNN index parameters (reference: src/vector_index.h:17-71)."""

    dim: int
    algo: VectorAlgo = VectorAlgo.FLAT
    metric: VectorMetric = VectorMetric.COSINE
    dtype: str = "FLOAT32"
    # IVF (HNSW-replacement) parameters. `m`/`ef_construction`/`ef_runtime`
    # are accepted for reference parity and mapped onto nlist/nprobe.
    nlist: int = 0           # 0 → auto: ~sqrt(N) at train time
    nprobe: int = 8
    m: int = 16
    ef_construction: int = 200
    ef_runtime: int = 10
    # TIERED front-buffer flush threshold.
    flat_buffer_limit: int = 1024
    multi: bool = False      # multi-value vector fields (one doc, many vecs)
    # Residency tier: "hbm" (device arrays, FLAT scan / device IVF) or
    # "host" (beyond-HBM: vectors stay in host RAM, device keeps only IVF
    # centroids, probed lists page per query batch — the disk-tier analog,
    # reference src/search_disk_api.h).
    storage: str = "hbm"
    # Compressed storage for the host tier (reference: SVS LVQ/LeanVec,
    # src/vector_index.h:17-71).  "LVQ8" stores per-vector-scaled uint8
    # codes (~4x capacity at equal memory, ops/lvq.py); reference codec
    # names (LVQ4, LVQ4x8, LeanVec…) are accepted as aliases so configs
    # load unchanged.  Only valid with storage="host".
    compression: str = ""

    def __post_init__(self):
        if isinstance(self.algo, str):  # accept "HNSW"/"SVS-VAMANA" aliases
            up = self.algo.upper()
            if up in ("HNSW", "SVS", "SVS-VAMANA", "IVF"):
                self.algo = VectorAlgo.IVF
            else:
                self.algo = VectorAlgo(up)
        if isinstance(self.metric, str):
            self.metric = VectorMetric(self.metric.upper())
        if self.dtype not in VECTOR_DTYPES:
            raise IndexError_(f"bad vector dtype {self.dtype}")
        if self.compression:
            up = self.compression.upper().replace("-", "").replace("_", "")
            if not (up.startswith("LVQ") or up.startswith("LEANVEC")):
                raise IndexError_(
                    f"bad vector compression {self.compression}")
            self.compression = "LVQ8"
            if self.storage != "host":
                raise IndexError_(
                    "vector compression requires storage='host' "
                    "(HBM tiers use dtype=INT8/BFLOAT16 instead)")


@dataclasses.dataclass
class GeometryParams:
    """Reference: src/geometry/ — coordinate system for WKT shapes."""

    system: str = "SPHERICAL"  # or FLAT (cartesian)


@dataclasses.dataclass
class Field:
    """One schema field (reference FieldSpec, src/field_spec.h).

    TEXT options: weight, nostem, phonetic, withsuffixtrie.
    TAG options: separator, casesensitive, withsuffixtrie.
    Common: sortable, noindex, indexmissing, indexempty.
    """

    name: str
    type: FieldType
    alias: Optional[str] = None      # AS clause: attribute path → alias
    weight: float = 1.0              # TEXT
    nostem: bool = False             # TEXT
    phonetic: Optional[str] = None   # TEXT: e.g. "dm:en"
    withsuffixtrie: bool = False     # TEXT/TAG: enables fast *infix*/suffix
    separator: str = ","             # TAG
    casesensitive: bool = False      # TAG
    sortable: bool = False
    unf: bool = False                # sortable un-normalized form
    noindex: bool = False
    indexmissing: bool = False       # enables ismissing(@f)
    indexempty: bool = False         # index empty-string values
    vector: Optional[VectorParams] = None
    geometry: Optional[GeometryParams] = None
    # Field id → bit in the text field mask (set by Schema).
    field_id: int = -1

    @property
    def attribute(self) -> str:
        """The name queries refer to (AS alias if present)."""
        return self.alias or self.name

    def __post_init__(self):
        if self.type == FieldType.VECTOR and self.vector is None:
            raise IndexError_(f"vector field {self.name} needs VectorParams")


# Index-wide storage flags (reference: spec.c:1703-1707 NOOFFSETS/NOHL/
# NOFIELDS/NOFREQS → Index_Store{TermOffsets,ByteOffsets,FieldFlags,Freqs}).
@dataclasses.dataclass
class IndexFlags:
    store_term_offsets: bool = True   # positions → phrase/slop/highlight
    store_field_flags: bool = True    # per-posting field masks
    store_freqs: bool = True          # term frequencies → TFIDF/BM25
    store_byte_offsets: bool = True   # highlighting byte offsets (host-side)


MAX_TEXT_FIELDS = 128  # reference: spec grows mask to 128 bits


@dataclasses.dataclass
class Schema:
    """The index schema + rules (reference IndexSpec, src/spec.h:297-357)."""

    name: str
    fields: list[Field] = dataclasses.field(default_factory=list)
    flags: IndexFlags = dataclasses.field(default_factory=IndexFlags)
    # SchemaRule analog (reference: src/rules.c): which docs belong here.
    prefixes: Sequence[str] = ("",)
    filter_expr: Optional[str] = None
    language: str = "english"
    language_field: Optional[str] = None
    score_field: Optional[str] = None
    default_score: float = 1.0
    payload_field: Optional[str] = None
    stopwords: Optional[Sequence[str]] = None  # None → default list
    on_json: bool = False
    # Index residency tier: "hbm" keeps posting CSR arrays on device;
    # "host" builds COLD segments — postings/positions/tag CSR stay in
    # host RAM and each query uploads only its term windows (beyond-HBM
    # text capacity; the disk-tier analog, reference src/search_disk*).
    # Dense per-doc columns (doclen, sortables, numerics, vectors) stay
    # on device either way — postings dominate index memory.
    storage: str = "hbm"

    def __post_init__(self):
        self._by_attr: dict[str, Field] = {}
        next_text_id = 0
        for f in self.fields:
            if f.type == FieldType.TEXT:
                if next_text_id >= MAX_TEXT_FIELDS:
                    raise IndexError_("too many TEXT fields")
                f.field_id = next_text_id
                next_text_id += 1
            key = f.attribute.lower()
            if key in self._by_attr:
                raise IndexError_(f"duplicate field {f.attribute}")
            self._by_attr[key] = f
        self.num_text_fields = next_text_id

    # -- lookups ---------------------------------------------------------
    def field(self, attribute: str) -> Field:
        f = self._by_attr.get(attribute.lower())
        if f is None:
            raise FieldNotFound(attribute)
        return f

    def try_field(self, attribute: str) -> Optional[Field]:
        return self._by_attr.get(attribute.lower())

    def text_fields(self) -> list[Field]:
        return [f for f in self.fields if f.type == FieldType.TEXT]

    def fields_of(self, *types: FieldType) -> list[Field]:
        return [f for f in self.fields if f.type in types]

    def text_field_mask(self, attributes: Optional[Sequence[str]]) -> int:
        """Resolve a list of field attributes to a bitmask over TEXT fields.

        None → all-fields mask (reference RS_FIELDMASK_ALL).
        """
        if attributes is None:
            return (1 << self.num_text_fields) - 1 if self.num_text_fields else 0
        mask = 0
        for a in attributes:
            f = self.field(a)
            if f.type != FieldType.TEXT or f.field_id < 0:
                raise FieldNotFound(a)
            mask |= 1 << f.field_id
        return mask

    def matches_key(self, key: str) -> bool:
        """SchemaRule prefix check (reference: src/rules.c)."""
        return any(key.startswith(p) for p in self.prefixes)

"""Index checkpoint save/restore, in the JAX package's on-disk format.

Counterpart of `redisearch_tpu/aux/checkpoint.py`: a checkpoint is a
directory of `arrays.npz` (every segment array, under the same member
names), `host.pkl` (schema, doc table, synonyms, term and tag
dictionaries, string tables, geometries, vector storage types) and
`meta.json` (FORMAT_VERSION 1).  A checkpoint written by either package
loads in the other:

* `host.pkl` names the host classes by their JAX package paths
  (`redisearch_tpu.schema.Schema`, ...).  The port writes its copies of
  those classes under those paths (`_Pickler`), and reads such names as
  its own copies (`_Unpickler`), never importing the JAX package; any
  other `redisearch_tpu` name is refused.
* `vec_dtypes` holds the JAX package's dtype names ("float32",
  "bfloat16", ...); vectors are stored as f32 (LVQ8 as uint8 codes with
  their `vqoff`/`vqscl` pair), so no bf16 numpy type is needed.
* IVF lists and the host tier's slabs are rebuilt at load from the saved
  centroids, by assignment only.

What the port derives besides (the planner's host mirrors, the
value-sorted numeric permutations, the bf16 scan copies) is rebuilt at
load by the constructors the builder seals with (`index/segment.py`).
"""

from __future__ import annotations

import importlib
import json
import os
import pickle
from typing import Any

import numpy as np
import torch

FORMAT_VERSION = 1

#: the port's copies of the JAX package's host modules that `host.pkl`
#: holds objects of: JAX package module -> the port's module
_COPIED = {f"redisearch_tpu.{m}": f"redisearch_tpu_torch.{m}"
           for m in ("schema", "index.doctable", "analysis.synonyms",
                     "utils.wkt")}
_PORT_TO_JAX = {v: k for k, v in _COPIED.items()}

#: storage dtype of a vector column <-> the JAX package's dtype name
_DTYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
                torch.float16: "float16", torch.int8: "int8",
                torch.uint8: "uint8"}
_SCHEMA_DTYPE = {"float32": "FLOAT32", "bfloat16": "BFLOAT16",
                 "float16": "FLOAT16", "int8": "INT8", "uint8": "UINT8",
                 "float64": "FLOAT64"}


def _port_module(name: str):
    """A module a checkpoint names: the port's copy of a JAX package host
    module, or any module outside the JAX package."""
    if name == "redisearch_tpu" or name.startswith("redisearch_tpu."):
        if name not in _COPIED:
            raise pickle.UnpicklingError(
                f"checkpoint names {name!r}, which the torch port has no "
                f"copy of (it reads {sorted(_COPIED)})")
        name = _COPIED[name]
    return importlib.import_module(name)


class _Unpickler(pickle.Unpickler):
    """Reads `redisearch_tpu.<mod>.<cls>` as the port's copy
    `redisearch_tpu_torch.<mod>.<cls>`."""

    def find_class(self, module, name):
        if module == "importlib" and name == "import_module":
            # the port's own checkpoints name their classes through it
            return _port_module
        if module == "redisearch_tpu" or module.startswith(
                "redisearch_tpu."):
            return getattr(_port_module(module), name)
        return super().find_class(module, name)


class _Pickler(pickle.Pickler):
    """Writes each class of the port's copied host modules as
    `getattr(importlib.import_module("redisearch_tpu.<mod>"), name)`: the
    JAX package's `pickle.load` resolves that to its own class (the two
    packages' enums never compare equal, so a JAX index must not hold the
    port's), and `_Unpickler` to the port's."""

    def reducer_override(self, obj):
        if isinstance(obj, type):
            jax_mod = _PORT_TO_JAX.get(obj.__module__)
            if jax_mod is not None:
                return getattr, (_ModuleRef(jax_mod), obj.__qualname__)
            if obj.__module__.startswith("redisearch_tpu_torch"):
                raise pickle.PicklingError(
                    f"{obj.__module__}.{obj.__qualname__} has no "
                    f"counterpart a JAX package checkpoint can hold")
        return NotImplemented


class _ModuleRef:
    """Pickles as `importlib.import_module(name)`."""

    def __init__(self, name: str):
        self.name = name

    def __reduce__(self):
        return importlib.import_module, (self.name,)


def _np(x) -> np.ndarray:
    """Host numpy copy of a tensor (bf16 widened to f32) or array."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


def _dtype_name(vecs) -> str:
    if isinstance(vecs, torch.Tensor):
        return _DTYPE_NAMES[vecs.dtype]
    return str(np.asarray(vecs).dtype)


def _collect_arrays(seg, prefix: str, arrays: dict, meta: dict):
    """Flatten a Segment's arrays into the npz dict."""

    def put(name, x):
        if x is not None and hasattr(x, "shape"):
            arrays[f"{prefix}.{name}"] = _np(x)

    put("gids", seg.gids)
    put("alive", seg.alive)
    put("doclen", seg.doclen)
    put("max_freq", seg.max_freq)
    put("docscore", seg.docscore)
    put("expire_at", seg.expire_at)
    t = seg.text
    for n in ("term_offsets", "doc_ids", "freqs", "field_masks",
              "doclens", "pos_offsets", "poskeys"):
        put(f"text.{n}", getattr(t, n))
    meta[prefix] = {
        "n_docs": seg.n_docs, "n_pad": seg.n_pad,
        "n_deleted": seg.n_deleted, "has_ttl": seg.has_ttl,
        "uniform_docscore": seg.uniform_docscore,
        "cold": seg.cold,
        "pos_stride": t.pos_stride,
        "pos_clamped": bool(t.pos_clamped), "nnz": t.nnz,
        "max_postings": t.max_postings,
        "tag_fields": list(seg.tags), "numeric_fields": list(seg.numerics),
        "geo_fields": list(seg.geos), "str_fields": list(seg.strcols),
        "vector_fields": list(seg.vectors), "missing_fields":
        list(seg.missing),
    }
    for attr, tp in seg.tags.items():
        put(f"tag.{attr}.offsets", tp.offsets)
        put(f"tag.{attr}.doc_ids", tp.doc_ids)
        if tp.codes is not None:
            put(f"tag.{attr}.codes", tp.codes)
        meta[prefix][f"tag.{attr}"] = {"nnz": tp.nnz,
                                       "max_postings": tp.max_postings}
    for attr, c in seg.numerics.items():
        put(f"num.{attr}.values", c.values)
        put(f"num.{attr}.present", c.present)
        if c.multi:
            put(f"num.{attr}.mv", c.multi_values)
            put(f"num.{attr}.mp", c.multi_present)
    for attr, g in seg.geos.items():
        put(f"geo.{attr}.lon", g.lon)
        put(f"geo.{attr}.lat", g.lat)
        put(f"geo.{attr}.present", g.present)
    for attr, s in seg.strcols.items():
        put(f"str.{attr}.value_ids", s.value_ids)
        put(f"str.{attr}.order", s.order)
    for attr, v in seg.vectors.items():
        if v.compression:
            # LVQ8: the codes (uint8) and their dequantization pair are
            # the source of truth
            put(f"vec.{attr}.vecs", v.vecs)
            put(f"vec.{attr}.vqoff", v.vq_off)
            put(f"vec.{attr}.vqscl", v.vq_scl)
        else:
            arrays[f"{prefix}.vec.{attr}.vecs"] = _np(v.vecs).astype(
                np.float32)
        put(f"vec.{attr}.present", v.present)
        put(f"vec.{attr}.sq", v.sq_norms)
        if v.multi:
            put(f"vec.{attr}.doc_rows", v.doc_rows)
        # trained centroids: load rebuilds the IVF / host-tier structures
        # by assignment only (no k-means retrain)
        if v.host and v.host_ivf is not None:
            put(f"vec.{attr}.cents", v.host_ivf.centroids)
        elif v.ivf is not None:
            put(f"vec.{attr}.cents", v.ivf.centroids)
        meta[prefix][f"vec.{attr}"] = {"dim": v.dim, "multi": v.multi,
                                       "host": v.host,
                                       "compression": v.compression}
    for attr, m in seg.missing.items():
        put(f"missing.{attr}", m)
    if seg.text_fexp is not None:
        put("text_fexp", seg.text_fexp)
    for attr, col in seg.field_fexp.items():
        put(f"fexp.{attr}", col)
    meta[prefix]["fexp_fields"] = list(seg.field_fexp)


def save(index, path: str) -> None:
    """Checkpoint a SearchIndex to `path` (a directory).  The npz members
    are stored, not compressed as the JAX package writes them (both
    packages' `np.load` reads either): zlib adds tens of seconds to the
    save of a 1M-doc index (PERF.md §6)."""
    index.commit()
    os.makedirs(path, exist_ok=True)
    arrays: dict[str, np.ndarray] = {}
    meta: dict[str, Any] = {"version": FORMAT_VERSION,
                            "n_segments": len(index.segments)}
    for i, seg in enumerate(index.segments):
        _collect_arrays(seg, f"seg{i}", arrays, meta)
    np.savez(os.path.join(path, "arrays.npz"), **arrays)
    host = {
        "schema": index.schema,
        "doctable": index.doctable,
        "synonyms": index.synonyms,
        "stopwords": list(index.stopwords),
        "terms": [(seg.terms.ids, seg.terms.terms, seg.terms.doc_freq)
                  for seg in index.segments],
        "tag_dicts": [{attr: (tp.ids, tp.values)
                       for attr, tp in seg.tags.items()}
                      for seg in index.segments],
        "strtables": [{attr: s.table for attr, s in seg.strcols.items()}
                      for seg in index.segments],
        "geometries": [seg.geometries for seg in index.segments],
        "gid_to_local": [seg.gid_to_local for seg in index.segments],
        "vec_dtypes": [{attr: _dtype_name(v.vecs)
                        for attr, v in seg.vectors.items()}
                       for seg in index.segments],
    }
    with open(os.path.join(path, "host.pkl"), "wb") as f:
        _Pickler(f).dump(host)
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f)


def load(path: str, device=None):
    """Restore a SearchIndex checkpoint (either package's) on `device`
    (default: the card)."""
    from ..index.index import SearchIndex
    from ..index.segment import (GeoColumn, StrColumn, TermDict,
                                 VectorColumn, make_numeric_column,
                                 make_segment, tag_postings, text_postings,
                                 vector_column)
    from ..ops.ivf import HostIVF, IVFIndex

    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    if meta.get("version") != FORMAT_VERSION:
        raise ValueError(f"bad checkpoint version {meta.get('version')}")
    with open(os.path.join(path, "host.pkl"), "rb") as f:
        host = _Unpickler(f).load()

    index = SearchIndex(host["schema"], device=device)
    device = index.device
    index.doctable = host["doctable"]
    index.synonyms = host["synonyms"]
    # a builder with the loaded synonyms (the JAX package's keeps the
    # empty map it was made with: ROADMAP §C)
    index._builder = index._new_builder()

    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    with np.load(os.path.join(path, "arrays.npz")) as npz:
        for i in range(meta["n_segments"]):
            p = f"seg{i}"
            sm = meta[p]

            def arr(name):
                return npz[f"{p}.{name}"]

            def has(name):
                return f"{p}.{name}" in npz.files

            n_docs = sm["n_docs"]
            csr = np.ascontiguousarray if sm.get("cold") else dev
            ids, terms, dfs = host["terms"][i]
            text = text_postings(
                *(arr(f"text.{n}") for n in (
                    "term_offsets", "doc_ids", "freqs", "field_masks",
                    "doclens", "pos_offsets", "poskeys")),
                csr, pos_stride=sm["pos_stride"],
                pos_clamped=bool(sm.get("pos_clamped", False)),
                nnz=sm["nnz"], max_postings=sm["max_postings"])
            tags = {}
            for attr in sm["tag_fields"]:
                tids, tvals = host["tag_dicts"][i][attr]
                tm = sm[f"tag.{attr}"]
                tags[attr] = tag_postings(
                    tids, tvals, arr(f"tag.{attr}.offsets"),
                    arr(f"tag.{attr}.doc_ids"), csr, nnz=tm["nnz"],
                    max_postings=tm["max_postings"],
                    codes=(dev(arr(f"tag.{attr}.codes"))
                           if has(f"tag.{attr}.codes") else None))
            numerics = {}
            for attr in sm["numeric_fields"]:
                col = np.where(arr(f"num.{attr}.present"),
                               arr(f"num.{attr}.values"), np.nan)
                lists = None
                if has(f"num.{attr}.mv"):
                    mv, mp = arr(f"num.{attr}.mv"), arr(f"num.{attr}.mp")
                    lists = [list(mv[r][mp[r]]) for r in range(n_docs)]
                numerics[attr] = make_numeric_column(col, n_docs, device,
                                                     value_lists=lists)
            geos = {attr: GeoColumn(lon=dev(arr(f"geo.{attr}.lon")),
                                    lat=dev(arr(f"geo.{attr}.lat")),
                                    present=dev(arr(f"geo.{attr}.present")))
                    for attr in sm["geo_fields"]}
            strcols = {}
            for attr in sm["str_fields"]:
                ids_t = dev(arr(f"str.{attr}.value_ids"))
                order = arr(f"str.{attr}.order")
                strcols[attr] = StrColumn(
                    value_ids=ids_t, table=host["strtables"][i][attr],
                    order=(ids_t if np.array_equal(
                        order, arr(f"str.{attr}.value_ids"))
                        else dev(order)))
            vectors = {}
            for attr in sm["vector_fields"]:
                vm = sm[f"vec.{attr}"]
                vp = index.schema.field(attr).vector
                metric = vp.metric.value
                cents = (arr(f"vec.{attr}.cents")
                         if has(f"vec.{attr}.cents") else None)
                mat = arr(f"vec.{attr}.vecs")
                pres = arr(f"vec.{attr}.present")
                sq = arr(f"vec.{attr}.sq")
                if vm.get("host"):
                    comp = vm.get("compression", "")
                    off = scl = hivf = None
                    if comp:
                        mat = mat.astype(np.uint8)
                        off = arr(f"vec.{attr}.vqoff").astype(np.float32)
                        scl = arr(f"vec.{attr}.vqscl").astype(np.float32)
                        if cents is not None:
                            hivf = HostIVF.build_lvq(
                                mat, off, scl, pres, metric,
                                centroids=cents, device=device)
                    elif cents is not None:
                        mat = mat.astype(np.float32)
                        hivf = HostIVF.build(mat, pres, metric,
                                             centroids=cents, device=device)
                    vectors[attr] = VectorColumn(
                        vecs=mat, present=dev(pres), dim=vm["dim"],
                        sq_norms=sq, host=True, host_ivf=hivf,
                        compression=comp, vq_off=off, vq_scl=scl)
                    continue
                col = vector_column(
                    mat.astype(np.float32), pres,
                    _SCHEMA_DTYPE[host["vec_dtypes"][i][attr]], device,
                    sq_norms=sq,
                    doc_rows=(arr(f"vec.{attr}.doc_rows")
                              if vm.get("multi") else None))
                if cents is not None:
                    col.ivf = IVFIndex.build(mat.astype(np.float32), pres,
                                             metric, centroids=cents,
                                             device=device)
                vectors[attr] = col
            index.segments.append(make_segment(
                device, n_docs, arr("gids"), arr("alive"), arr("doclen"),
                arr("max_freq"), arr("docscore"), arr("expire_at"),
                terms=TermDict(ids=ids, terms=terms,
                               doc_freq=np.asarray(dfs)),
                text=text, tags=tags, numerics=numerics, geos=geos,
                strcols=strcols, vectors=vectors,
                missing={attr: dev(arr(f"missing.{attr}"))
                         for attr in sm["missing_fields"]},
                gid_to_local=host["gid_to_local"][i],
                geometries=host["geometries"][i],
                n_deleted=sm.get("n_deleted", 0),
                has_ttl=sm.get("has_ttl", True),
                uniform_docscore=sm.get("uniform_docscore", False),
                cold=bool(sm.get("cold")),
                text_fexp=(dev(arr("text_fexp")) if has("text_fexp")
                           else None),
                field_fexp={attr: dev(arr(f"fexp.{attr}"))
                            for attr in sm.get("fexp_fields", [])}))
    return index

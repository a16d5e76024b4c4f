"""The data of a configuration, drawn from the seed by one general drawer.

A configuration file (`configs/<name>.json`) lists its fields; each field
says how its values are drawn:

* TAG: `zipf`, one of `n_values` labels a document (named by `format`),
  label i with probability proportional to (i + 1) ** -a;
* NUMERIC: `uniform_int`, a whole number uniform in [lo, hi);
* VECTOR: `unit_normal` rows of `dim` float32 values, normalised;
* TEXT: `zipf_words`, `tokens` words a document (a whole number, or
  `{"min": a, "max": b, "median": m, "sigma": s}` for a lognormal length
  of median m and shape s, rounded and clipped to [a, b]), each word of rank i among the `vocab` words (named by `format`, rank i
  the word `format % i`) with probability proportional to (i + 1) ** -a.
  A TEXT field's `weight` and `nostem` are the schema's, not the draw's.

Everything random is drawn on the given device with `torch.Generator`s
seeded from (seed, field), in a few large calls, so the same seed gives
the same data.  The drawn arrays (`Dataset`) are what both sides get: the
program as documents (`Dataset.docs`), the plain reference as arrays.

The vectors are `redisearch_tpu_torch/bench/workloads.py` `fknn_corpus`'s
draw, made in bulk on the card instead of one Python dict a row.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))


def load_json(kind: str, name: str) -> dict:
    """`<kind>/<name>.json` under the benchmark's folder."""
    with open(os.path.join(HERE, kind, name + ".json")) as f:
        return json.load(f)


def stream_seed(seed: int, *stream: int) -> int:
    """A 63-bit seed for one stream of draws of a run's seed (any whole
    number, negative or above 32 bits included)."""
    h = seed % (1 << 64)
    for s in stream:
        h = (h * 0x9E3779B97F4A7C15 + s + 1) % (1 << 64)
        h ^= h >> 29
    return h % (1 << 63)


def generator(dev: torch.device, seed: int, *stream: int) -> torch.Generator:
    g = torch.Generator(device=dev)
    g.manual_seed(stream_seed(seed, *stream))
    return g


def zipf_weights(n: int, a: float) -> np.ndarray:
    """Probabilities of labels 0..n-1, label i proportional to
    (i + 1) ** -a."""
    w = np.arange(1, n + 1, dtype=np.float64) ** -float(a)
    return w / w.sum()


@dataclasses.dataclass
class Text:
    """A TEXT field's words: document r holds the words
    `words[ids[offsets[r]:offsets[r + 1]]]`, in order."""
    ids: np.ndarray      # int32 [tokens of all documents]
    lens: np.ndarray     # int32 [n]: tokens of each document
    words: np.ndarray    # object [vocabulary]: the word of each id

    @property
    def offsets(self) -> np.ndarray:
        return np.concatenate([[0], np.cumsum(self.lens, dtype=np.int64)])

    def joined(self) -> list:
        """Each document's text: its words joined by single spaces."""
        toks = self.words[self.ids].tolist()
        off = self.offsets.tolist()
        return [" ".join(toks[a:b]) for a, b in zip(off[:-1], off[1:])]


@dataclasses.dataclass
class Dataset:
    """A configuration's drawn data: row r is document r, of key
    `keys[r]`, in the order of the bulk load."""
    cfg: dict
    n: int
    tags: dict          # field -> int32 [n] label codes
    numeric: dict       # field -> float64 [n]
    vectors: dict       # field -> float32 [n, dim] tensor on `dev`
    keys: list
    dev: torch.device
    texts: dict = dataclasses.field(default_factory=dict)  # field -> Text

    def field(self, name: str) -> dict:
        return next(f for f in self.cfg["fields"] if f["name"] == name)

    def tag_values(self, field: str) -> list:
        f = self.field(field)
        return [f["format"] % i for i in range(f["n_values"])]

    def tag_weights(self, field: str) -> np.ndarray:
        f = self.field(field)
        return zipf_weights(f["n_values"], f["a"])

    def docs(self) -> list:
        """(key, fields) of every document, as the program's
        `add_documents` takes them."""
        names, cols = [], []
        for f in self.cfg["fields"]:
            nm, ty = f["name"], f["type"]
            names.append(nm)
            if ty == "TAG":
                vals = self.tag_values(nm)
                cols.append([vals[c] for c in self.tags[nm].tolist()])
            elif ty == "NUMERIC":
                cols.append(self.numeric[nm].tolist())
            elif ty == "VECTOR":
                cols.append(list(self.vectors[nm].cpu().numpy()))
            elif ty == "TEXT":
                cols.append(self.texts[nm].joined())
        return [(k, dict(zip(names, vals)))
                for k, *vals in zip(self.keys, *cols)]


def draw(cfg: dict, seed: int, dev: torch.device) -> Dataset:
    """The configuration's bulk load, `cfg["n_docs"]` documents."""
    n = cfg["n_docs"]
    out = {"tags": {}, "numeric": {}, "vectors": {}, "texts": {}}
    for j, f in enumerate(cfg["fields"]):
        g = generator(dev, seed, j)
        nm, ty, how = f["name"], f["type"], f.get("draw")
        if ty == "TAG" and how == "zipf":
            cdf = torch.from_numpy(np.cumsum(zipf_weights(
                f["n_values"], f["a"]))).to(dev)
            u = torch.rand(n, generator=g, device=dev, dtype=torch.float64)
            codes = torch.searchsorted(cdf, u, right=True).clamp_(
                max=f["n_values"] - 1)
            out["tags"][nm] = codes.to(torch.int32).cpu().numpy()
        elif ty == "NUMERIC" and how == "uniform_int":
            out["numeric"][nm] = torch.randint(
                f["lo"], f["hi"], (n,), generator=g, device=dev).cpu(
            ).numpy().astype(np.float64)
        elif ty == "VECTOR" and how == "unit_normal":
            v = torch.randn(n, f["dim"], generator=g, device=dev,
                            dtype=torch.float32)
            out["vectors"][nm] = v / v.norm(dim=1, keepdim=True)
        elif ty == "TEXT" and how == "zipf_words":
            out["texts"][nm] = _zipf_words(f, n, g, dev)
        else:
            raise ValueError(f"field {nm}: no draw {how!r} for {ty}")
    return Dataset(cfg=cfg, n=n, keys=[cfg["key_format"] % i
                                       for i in range(n)], dev=dev, **out)


def _zipf_words(f: dict, n: int, g: torch.Generator,
                dev: torch.device) -> Text:
    """A `zipf_words` TEXT field: each document's length, then all its
    words, from the field's own stream."""
    t = f["tokens"]
    if isinstance(t, int):
        lens = torch.full((n,), t, dtype=torch.int64, device=dev)
    else:
        z = torch.randn(n, generator=g, device=dev, dtype=torch.float64)
        lens = torch.exp(np.log(t["median"]) + t["sigma"] * z).round_(
            ).clamp_(t["min"], t["max"]).to(torch.int64)
    total = int(lens.sum())
    cdf = torch.from_numpy(np.cumsum(zipf_weights(f["vocab"], f["a"]))).to(
        dev)
    u = torch.rand(total, generator=g, device=dev, dtype=torch.float64)
    ids = torch.searchsorted(cdf, u, right=True).clamp_(max=f["vocab"] - 1)
    fmt = f["format"]
    return Text(ids=ids.to(torch.int32).cpu().numpy(),
                lens=lens.to(torch.int32).cpu().numpy(),
                words=np.array([fmt % i for i in range(f["vocab"])],
                               dtype=object))

"""The data of a configuration, drawn from the seed by one general drawer.

A configuration file (`configs/<name>.json`) lists its fields; each field
says how its values are drawn:

* TAG: `zipf`, one of `n_values` labels a document (named by `format`),
  label i with probability proportional to (i + 1) ** -a;
* NUMERIC: `uniform_int`, a whole number uniform in [lo, hi);
* VECTOR: `unit_normal` rows of `dim` float32 values, normalised.

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
        return [(k, dict(zip(names, vals)))
                for k, *vals in zip(self.keys, *cols)]


def draw(cfg: dict, seed: int, dev: torch.device) -> Dataset:
    """The configuration's bulk load, `cfg["n_docs"]` documents."""
    n = cfg["n_docs"]
    out = {"tags": {}, "numeric": {}, "vectors": {}}
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
        else:
            raise ValueError(f"field {nm}: no draw {how!r} for {ty}")
    return Dataset(cfg=cfg, n=n, keys=[cfg["key_format"] % i
                                       for i in range(n)], dev=dev, **out)

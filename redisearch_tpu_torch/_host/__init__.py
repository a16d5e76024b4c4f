"""The JAX package's host-only modules, reached without importing jax.

`redisearch_tpu/__init__.py` imports the query engine, which imports jax,
so `import redisearch_tpu.schema` loads jax on the way.  This package
points its `__path__` at the `redisearch_tpu/` directory instead:
`redisearch_tpu_torch._host.query.parser` loads `redisearch_tpu/query/
parser.py` as a module of this package, and its relative imports
(`from ..schema import ...`) resolve inside `_host` too.  One source of
truth, no copies, and `redisearch_tpu/__init__.py` never runs.

Use it only for modules that import no jax at module level: `schema`,
`analysis/*`, `utils/*`, `query/ast`, `query/parser`, `query/expand`,
`index/doctable`, `native`, and the host helpers of `index/segment`,
`index/builder` and `index/bulk`.

These are other module objects than `redisearch_tpu.schema` and friends:
`_host.schema.FieldType.TEXT != redisearch_tpu.schema.FieldType.TEXT`.
Build each package's `Schema` from that package's own classes.
"""

import importlib
import importlib.abc
import os
import sys

__path__ = [os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "redisearch_tpu")]


class _HideJax(importlib.abc.MetaPathFinder):
    """While installed, `import jax` fails as if jax were absent."""

    def find_spec(self, fullname, path=None, target=None):
        if fullname == "jax" or fullname.startswith("jax."):
            raise ImportError(f"{fullname} is hidden from the torch port")
        return None


def _import_hiding_jax(name: str):
    if "jax" in sys.modules:    # loaded already, by someone else
        return importlib.import_module(name)
    finder = _HideJax()
    sys.meta_path.insert(0, finder)
    try:
        return importlib.import_module(name)
    finally:
        sys.meta_path.remove(finder)


# index/segment.py tries `import jax.numpy` at module level and carries on
# without it; where jax is installed that try would load it.  Load the
# module here with jax hidden, before anything imports it.
_import_hiding_jax(__name__ + ".index.segment")

# Copy of redisearch_tpu/utils/errors.py: the port imports nothing of the JAX package.
"""Error types for redisearch_tpu.

Mirrors the error surface of the reference's QueryError codes
(reference: src/query_error.h, src/redisearch_rs/query_error) without the
RESP plumbing: everything is a Python exception with a short code string.
"""

from __future__ import annotations


class RSError(Exception):
    """Base error. `code` mirrors the reference's QueryErrorCode names."""

    code = "EGENERIC"

    def __init__(self, message: str = ""):
        super().__init__(message)
        self.message = message


class IndexError_(RSError):
    code = "EINDEX"


class IndexNotFound(RSError):
    code = "ENOINDEX"

    def __init__(self, name: str):
        super().__init__(f"{name}: no such index")
        self.name = name


class IndexExists(RSError):
    code = "EINDEXEXISTS"


class FieldNotFound(RSError):
    code = "ENOPROPKEY"

    def __init__(self, field: str):
        super().__init__(f"Unknown field `{field}`")
        self.field = field


class WrongFieldType(RSError):
    code = "EBADFIELD"


class DocumentExists(RSError):
    """FT.ADD without REPLACE on an existing doc (reference:
    QUERY_ERROR_CODE_DOC_EXISTS, src/document_add.c:180)."""
    code = "EDOCEXISTS"


class QuerySyntaxError(RSError):
    code = "ESYNTAX"


class ParamError(RSError):
    """Missing/invalid $param (reference: src/param.c)."""

    code = "EBADVAL"


class TimeoutError_(RSError):
    code = "ETIMEDOUT"


class CursorNotFound(RSError):
    code = "ECURSORNOTFOUND"


class DocumentNotFound(RSError):
    code = "ENODOC"


class ConfigError(RSError):
    code = "EBADCONF"

# Copy of redisearch_tpu/utils/log.py: the port imports nothing of the JAX package.
"""Logging + user-data obfuscation.

Reference: src/obfuscation/ (obfuscation_api.h) — when the
`hide-user-data-from-log` config is on, user-identifying names are
replaced in every log line with stable obfuscated handles:

    index name    -> Index@<sha1(name)>
    field         -> Field@<field id>
    field path    -> FieldPath@<field id>
    document key  -> Document@<doc id>   (or Key@<time> before id assignment)
    user text     -> Text

The flag is process-global (mirrors the reference's single module config)
and is flipped by `FT.CONFIG SET HIDE_USER_DATA_FROM_LOG`.
"""

from __future__ import annotations

import hashlib
import logging

logger = logging.getLogger("redisearch_tpu")

hide_user_data = False


def set_hide_user_data(flag: bool) -> None:
    global hide_user_data
    hide_user_data = bool(flag)


def obfuscate_index(name: str) -> str:
    return "Index@" + hashlib.sha1(name.encode("utf-8",
                                               "surrogateescape")).hexdigest()


def obfuscate_field(field_id: int) -> str:
    return f"Field@{field_id}"


def obfuscate_field_path(field_id: int) -> str:
    return f"FieldPath@{field_id}"


def obfuscate_document(doc_id: int) -> str:
    return f"Document@{doc_id}"


def obfuscate_key(ts: float) -> str:
    return f"Key@{int(ts)}"


def obfuscate_text(_s: str) -> str:
    return "Text"


def fmt_index(name: str) -> str:
    return obfuscate_index(name) if hide_user_data else name


def fmt_doc(key: str, gid: int = -1) -> str:
    if not hide_user_data:
        return key
    return obfuscate_document(gid) if gid >= 0 else "Document@?"


def fmt_text(s: str) -> str:
    return obfuscate_text(s) if hide_user_data else s

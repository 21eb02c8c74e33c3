"""Typed store errors.

Mirrors the error taxonomy of the reference store layer
(reference common/errors.go:5-47): KeyNotFound / TooLate / PassedIndex /
SkippedIndex / NoRoot, with an `is_store_err` matcher used by callers to
tolerate specific error classes (e.g. DivideRounds tolerates KeyNotFound,
reference hashgraph/hashgraph.go:626).
"""

from __future__ import annotations

import enum


class StoreErrType(enum.Enum):
    KEY_NOT_FOUND = "Not Found"
    TOO_LATE = "Too Late"
    PASSED_INDEX = "Passed Index"
    SKIPPED_INDEX = "Skipped Index"
    NO_ROOT = "No Root"


class StoreError(Exception):
    def __init__(self, err_type: StoreErrType, key: str = ""):
        self.err_type = err_type
        self.key = key
        super().__init__(f"{key}, {err_type.value}")


def is_store_err(err: object, err_type: StoreErrType) -> bool:
    return isinstance(err, StoreError) and err.err_type == err_type

"""Typed errors of the port (counterpart of paddle_tpu/errors.py).

Only the classes the port raises. Each one is an `EnforceNotMet` and
also the Python builtin it naturally is, so callers can catch either.
"""

from __future__ import annotations

import enum


class ErrorCode(enum.IntEnum):
    """platform/error_codes.proto Code enum (same numbering)."""

    INVALID_ARGUMENT = 1
    NOT_FOUND = 2
    RESOURCE_EXHAUSTED = 5
    PRECONDITION_NOT_MET = 6
    UNIMPLEMENTED = 9
    EXTERNAL = 12


class EnforceNotMet(Exception):
    code = ErrorCode.INVALID_ARGUMENT

    def __init__(self, message, op=None):
        self.op_type = getattr(op, "type", op)
        self.message = message
        text = str(message)
        if self.op_type:
            text += f"\n  [operator context: op {self.op_type!r}]"
        text += f"\n  [error code: {self.code.name} ({self.code.value})]"
        super().__init__(text)


class InvalidArgumentError(EnforceNotMet, ValueError):
    code = ErrorCode.INVALID_ARGUMENT


class NotFoundError(EnforceNotMet, RuntimeError):
    code = ErrorCode.NOT_FOUND


class PreconditionNotMetError(EnforceNotMet, RuntimeError):
    code = ErrorCode.PRECONDITION_NOT_MET


class UnimplementedError(EnforceNotMet, NotImplementedError):
    code = ErrorCode.UNIMPLEMENTED


class CheckpointCorruptionError(EnforceNotMet, OSError):
    """A checkpoint failed integrity verification (torn write, CRC, shape
    or dtype mismatch against its manifest, undecodable container).
    Raised by io.py's load paths before any scope is written. Retrying
    cannot help: the caller falls back to an older checkpoint."""

    code = ErrorCode.EXTERNAL


class StorageExhaustedError(EnforceNotMet, OSError):
    """A durable write ran out of disk: ENOSPC/EDQUOT from the filesystem,
    or the preflight found less free room than the payload needs. The
    failed write leaves no temp file behind; retry once space is freed."""

    code = ErrorCode.RESOURCE_EXHAUSTED


class ProgramVerifyError(PreconditionNotMetError):
    """The static verifier (analysis/) found ERROR findings under
    ``PADDLE_TPU_VERIFY=strict``: the Program is malformed (use-before-def,
    shape/dtype desync against the emitters, a rank-divergent collective
    schedule, ...). Raised where the executor builds the run's plan, before
    any op runs. ``findings`` holds the structured ``analysis.Finding``
    list; ``loc`` the first one's source frame, where the op carries one.
    Retrying cannot help: the graph itself must be fixed."""

    code = ErrorCode.PRECONDITION_NOT_MET

    def __init__(self, message, findings=None, op=None, loc=None):
        self.findings = list(findings or [])
        self.user_loc = loc
        super().__init__(message, op=op)


class ProgramVerifyWarning(UserWarning):
    """Category of the warnings the static verifier emits in its default
    ``PADDLE_TPU_VERIFY=warn`` mode. Filter with
    ``warnings.filterwarnings(..., category=ProgramVerifyWarning)``."""

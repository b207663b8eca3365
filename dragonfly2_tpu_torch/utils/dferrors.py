"""Typed service errors (reference: internal/dferrors — gRPC-coded errors
the services use to signal retryable vs terminal conditions)."""

from __future__ import annotations

import enum


class Code(enum.IntEnum):
    """Wire-stable error codes (subset of the reference's dfcodes)."""

    OK = 0
    UNKNOWN = 1
    INVALID_ARGUMENT = 3
    NOT_FOUND = 5
    RESOURCE_EXHAUSTED = 8
    FAILED_PRECONDITION = 9
    UNAVAILABLE = 14
    SCHEDULE_FAILED = 1000
    NEED_BACK_TO_SOURCE = 1001
    PEER_GONE = 1002
    TASK_GONE = 1003


class DfError(Exception):
    code: Code = Code.UNKNOWN
    retryable: bool = False

    def __init__(self, message: str = "", *, code: Code | None = None):
        super().__init__(message or self.__class__.__name__)
        if code is not None:
            self.code = code


class NotFoundError(DfError):
    code = Code.NOT_FOUND


class InvalidArgumentError(DfError):
    code = Code.INVALID_ARGUMENT


class UnavailableError(DfError):
    code = Code.UNAVAILABLE
    retryable = True


class ResourceExhaustedError(DfError):
    code = Code.RESOURCE_EXHAUSTED
    retryable = True


class ScheduleFailedError(DfError):
    code = Code.SCHEDULE_FAILED


class NeedBackToSourceError(DfError):
    code = Code.NEED_BACK_TO_SOURCE


def is_retryable(exc: BaseException) -> bool:
    return isinstance(exc, DfError) and exc.retryable

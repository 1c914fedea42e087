"""Typed errors — a copy of ``paddle_tpu.core.enforce``.

Paddle's PADDLE_ENFORCE macros and error codes: every error carries a
typed category, so callers and tests can assert on the failure class.
"""
from __future__ import annotations


class EnforceNotMet(RuntimeError):
    """Base error, parity with platform::EnforceNotMet."""


class InvalidArgumentError(EnforceNotMet, ValueError):
    pass


class NotFoundError(EnforceNotMet, KeyError):
    pass


class OutOfRangeError(EnforceNotMet, IndexError):
    pass


class AlreadyExistsError(EnforceNotMet):
    pass


class ResourceExhaustedError(EnforceNotMet, MemoryError):
    pass


class PreconditionNotMetError(EnforceNotMet):
    pass


class PermissionDeniedError(EnforceNotMet):
    pass


class ExecutionTimeoutError(EnforceNotMet, TimeoutError):
    pass


class UnimplementedError(EnforceNotMet, NotImplementedError):
    pass


class UnavailableError(EnforceNotMet):
    pass


class FatalError(EnforceNotMet):
    pass


class ExternalError(EnforceNotMet):
    pass


def enforce(cond, message: str, error_cls=InvalidArgumentError):
    if not cond:
        raise error_cls(message)


def enforce_eq(a, b, message: str = "", error_cls=InvalidArgumentError):
    if a != b:
        raise error_cls(f"expected {a!r} == {b!r}. {message}")


def enforce_gt(a, b, message: str = "", error_cls=InvalidArgumentError):
    if not a > b:
        raise error_cls(f"expected {a!r} > {b!r}. {message}")


def enforce_ge(a, b, message: str = "", error_cls=InvalidArgumentError):
    if not a >= b:
        raise error_cls(f"expected {a!r} >= {b!r}. {message}")


def enforce_not_none(x, message: str = "", error_cls=NotFoundError):
    if x is None:
        raise error_cls(f"expected a value, got None. {message}")
    return x

"""Typed errors raised on the port's serving and training paths.

Counterpart of `paddle_tpu/core/enforce.py`: each typed error subclasses
the matching builtin, so callers that catch builtins keep working while
`type(e).__name__` carries the classification.
"""
from __future__ import annotations


class InvalidArgumentError(ValueError):
    pass


class NotFoundError(FileNotFoundError):
    pass


class UnimplementedError(NotImplementedError):
    pass


class UnavailableError(RuntimeError):
    pass


__all__ = ["InvalidArgumentError", "NotFoundError", "UnimplementedError",
           "UnavailableError"]

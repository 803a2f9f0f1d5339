"""errno-mirroring error contract (reference API_SPEC.md:36-96).

The reference returns negative errno values from every API entry point
(-EINVAL, -ERANGE, -ENOMEM; see src/phy/phy.cpp and
tests/error_code_test.cpp).  This tensor library signals the same
conditions as typed exceptions carrying the matching errno so callers can
program against an identical contract.
"""
from __future__ import annotations

import errno as _errno

__all__ = ["LoraError", "InvalidArgumentError", "RangeError", "NoMemoryError",
           "MicMismatchError", "EINVAL", "ERANGE", "ENOMEM"]

EINVAL = _errno.EINVAL
ERANGE = _errno.ERANGE
ENOMEM = _errno.ENOMEM


class LoraError(ValueError):
    """Base error with an ``errno`` attribute mirroring the C contract."""

    errno: int = EINVAL

    def __init__(self, message: str, errno: int | None = None):
        super().__init__(message)
        if errno is not None:
            self.errno = errno


class InvalidArgumentError(LoraError):
    """-EINVAL: invalid arguments / inconsistent sample counts."""

    errno = EINVAL


class RangeError(LoraError):
    """-ERANGE: buffer too small / too few symbols / amplitude overflow."""

    errno = ERANGE


class NoMemoryError(LoraError):
    """-ENOMEM: a required buffer is missing (phy.cpp:37-38)."""

    errno = ENOMEM


class MicMismatchError(InvalidArgumentError):
    """-EINVAL on LoRaWAN MIC verification failure (lorawan.cpp:159-161)."""

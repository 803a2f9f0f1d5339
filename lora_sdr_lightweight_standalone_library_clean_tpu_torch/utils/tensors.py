"""Tensor helpers shared by the ops: cached device tables, input placement.

The ops build their constant tables on the host in numpy (float64 math,
float32 result, exactly as the JAX package builds them) and move them to
the device of the tensors they work on.  ``device_table`` keeps one copy
per (table function, arguments, device), so a hot loop on the card copies no
table from the host after its first call.

Host data (numpy arrays, lists) handed to an entry point goes to the CUDA
card: the port runs on the card unless the caller asks for the CPU, with a
CPU tensor or an explicit ``device="cpu"``.  Without a card, host data
raises instead of running on the CPU (``host_device``).

The float32 matrix products of the port (the DFTs of ``ops/dft.py``, which
the estimator and every plain version run) must not run in TF32, which
keeps about three decimal digits: enough to move a CFO, a timing estimate
or a detection.  ``full_float32`` runs them in full float32 whatever the
caller's switch is, and gives the switch back as it found it.
"""
from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch

from .errors import InvalidArgumentError

__all__ = ["device_table", "host_device", "int_tensor", "full_float32"]


@contextlib.contextmanager
def full_float32():
    """Run the float32 matmuls inside in full float32 (no TF32).

    The switch is ``torch.backends.cuda.matmul.allow_tf32``, which
    ``torch.get_float32_matmul_precision()`` reflects ("highest" means
    off).  When it is on, this sets "highest" and restores the caller's
    precision in a ``finally``.  Raises ``InvalidArgumentError`` when the
    caller set TF32 through the per-backend ``fp32_precision`` API alone,
    where torch refuses to read the switch at all: the products cannot be
    pinned without changing the caller's settings behind its back.  Not
    thread-safe while the caller's TF32 is on (the switch is global)."""
    try:
        saved = torch.get_float32_matmul_precision()
    except RuntimeError as e:
        raise InvalidArgumentError(
            "cannot pin full float32 matmuls: torch reports a mix of its "
            "legacy and per-backend TF32 settings; set TF32 through "
            "torch.set_float32_matmul_precision or "
            "torch.backends.cuda.matmul.allow_tf32") from e
    if saved == "highest":
        yield
        return
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(saved)


@functools.lru_cache(maxsize=None)
def _cached(make_table, args, device):
    out = make_table(*args)
    if isinstance(out, tuple):
        return tuple(torch.as_tensor(a, device=device) for a in out)
    return torch.as_tensor(out, device=device)


def device_table(make_table, *args, device):
    """``make_table(*args)`` (a numpy array or a tuple of them) as tensors on
    ``device``.  Callers must not modify the result in place."""
    return _cached(make_table, args, torch.device(device))


def host_device(device=None) -> torch.device:
    """The device host data goes to: ``device`` when the caller names one,
    else the CUDA card.  Raises ``RuntimeError`` when that is a CUDA device
    and there is no card: the port never falls back to the CPU by itself."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "host data runs on the CUDA card unless the caller asks for the "
            "CPU, and no CUDA card is available: pass a CPU tensor or "
            "device='cpu' to run on the CPU")
    return dev


def int_tensor(x, dtype=torch.int64) -> torch.Tensor:
    """An integer tensor of ``dtype`` from a tensor (device kept) or from
    host data (placed on the CUDA card, ``host_device``).  Host data goes
    through numpy int64 so unsigned numpy inputs (uint16 symbols) convert
    without torch's limited unsigned-type support."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype)
    dev = host_device()
    return torch.as_tensor(np.asarray(x).astype(np.int64)).to(dev, dtype)

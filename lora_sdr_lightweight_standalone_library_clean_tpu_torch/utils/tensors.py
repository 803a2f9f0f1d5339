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
"""
from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["device_table", "host_device", "int_tensor"]


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

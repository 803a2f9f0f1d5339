"""The system under test: the PyTorch/CUDA port, and the entry point a
cell's kind drives on it.

This is the one module of the benchmark that imports the port.  A call
takes one pool input and returns the program's outputs; nothing here
reads them back to the host, so a call's wall time is the program's."""
from __future__ import annotations

import importlib

PORT = "lora_sdr_lightweight_standalone_library_clean_tpu_torch"

__all__ = ["PORT", "load", "join", "entry"]


def load():
    """Import the port (its kernels build or load at their first call)."""
    return importlib.import_module(PORT)


def join(backend: str) -> bool:
    """Join this rank's process group through the port's own
    ``init_distributed``, as a user under ``torchrun`` does: it reads the
    rank's environment, and with NCCL takes card ``LOCAL_RANK``."""
    distributed = importlib.import_module(PORT + ".parallel.distributed")
    return distributed.init_distributed(backend=backend)


def entry(cell, phy):
    """The call the cell's traffic drives: a function of one input."""
    lora = load()
    cfg = cell.config
    params = lora.LoraParams(sf=cfg["sf"], bw=cfg["bw"], cr=cfg["cr"],
                             osr=cfg["osr"], sync_word=cfg["sync_word"])
    return cell.kind.entry(lora, params, cell.mix, phy)

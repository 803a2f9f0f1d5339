"""MB a call that this rank puts into the sharded receiver's collectives:
the growth of the port's ``COUNTS["collective_bytes.<halo|scan|results>"]``
over one further call of the cell (host-side counters, which the shapes
set, the same every call; every rank makes the call, so the ranks stay in
lockstep).  None without a traced run, or for a program whose counters
hold no collective bytes."""
import importlib

from portbench import program

PREFIX = "collective_bytes."


def _sent(counts) -> int:
    return sum(v for k, v in list(counts.items()) if k.startswith(PREFIX))


def read(run):
    if getattr(run, "call", None) is None \
            or getattr(run, "trace", None) is None:
        return None
    try:
        counts = importlib.import_module(program.PORT + ".utils.spans").COUNTS
    except (ImportError, AttributeError):
        return None
    before = _sent(counts)
    run.call()
    if run.device.type == "cuda":
        import torch
        torch.cuda.synchronize()
    return (_sent(counts) - before) / 1e6 or None

"""``stream_frames``' stream of SX1272 frames, split in time over the
``sp`` ranks of one host: the port's sharded stream path.

Each rank runs on its own card (``ranks.py``).  ``entry`` builds the
port's ``global_mesh(dp=1, sp=...)`` once, takes this rank's block of
each input's planes as a view the first time it sees the input (in
set-up: the window's calls find it made), wraps it with the port's
local-block entry ``stream_block``, and calls ``receive_stream_frames``
with the mesh: each rank receives only its own block, as in a deployment
whose cards each receive a part of the capture.  Every rank returns the
whole call's frames, so ``build``, ``outputs``, ``reference`` and
``compare`` are ``stream_frames``', and ``shapes`` sizes the whole call,
with ``sp`` for the readers that count one rank's share.

Mix keys: ``stream_frames``', and ``sp`` (the ranks the stream is split
over; the run's world, dp 1).
"""
from __future__ import annotations

import importlib

import torch.distributed as dist

from portbench import generate
from portbench.kinds import stream_frames as frames

NUMBERS = frames.NUMBERS
FAILED = frames.FAILED
build = frames.build
outputs = frames.outputs
reference = frames.reference
compare = frames.compare


def shapes(mix: dict, phy) -> dict:
    return {**frames.shapes(mix, phy), "sp": mix["sp"]}


def entry(lora, params, mix: dict, phy):
    par = importlib.import_module(lora.__name__ + ".parallel.distributed")
    # a program without the local-block entry cannot run the cell: it
    # fails here, before any input is made
    block_of = par.stream_block
    mesh = par.global_mesh(
        dp=1, sp=mix["sp"],
        device="cuda" if dist.get_backend() == "nccl" else "cpu")
    me = mesh.get_local_rank("sp")
    rows = frames.row_symbols(mix, phy)
    kw = {"max_payload_len": mix["max_payload_len"],
          "max_packets": generate.slots(mix, phy, rows),
          "stride": generate.stride(mix, phy),
          "power_gate_db": float(mix["power_gate_db"])}
    blocks = {}

    def call(inp):
        key = tuple((a.data_ptr(), a.shape[0]) for a in inp.args)
        planes = blocks.get(key)
        if planes is None:
            size = inp.args[0].shape[0] // mix["sp"]
            planes = blocks[key] = block_of(
                *(a[me * size:(me + 1) * size] for a in inp.args), mesh)
        out, _ = lora.receive_stream_frames(*planes, params, mesh=mesh,
                                            axis="sp", **kw)
        return out
    return call

"""Multi-process execution: ``torch.distributed`` wiring and the
('host', 'dp', 'sp') mesh.

PyTorch port of ``lora_sdr_lightweight_standalone_library_clean_tpu/
parallel/distributed.py``.  The workload's parallel dimensions map onto a
3-axis global mesh of ranks, one rank per device:

 * ``host``: the node.  Channels (independent radio streams or packet
   batches) shard here first: the per-channel pipeline has no
   cross-channel communication, so the only traffic between nodes is small
   metric reductions.
 * ``dp``: data parallelism over channels/packets within a node.
 * ``sp``: sequence parallelism over a stream's time blocks within a node,
   with halos of the next blocks' leading samples (``parallel/
   streaming.py``, ``parallel/receiver.py``); ``sp`` never spans nodes.

Ranks are grouped into hosts by ``LOCAL_WORLD_SIZE`` (the ranks per node,
as ``torchrun`` sets it; all ranks form one host without it).  ``torchrun``
numbers the ranks of node k contiguously, so the sorted ranks reshaped to
(hosts, dp, sp) give host rows that are exactly the nodes.

The backend is explicit: ``init_distributed`` defaults to NCCL, the card's
backend, and raises without a card; a CPU mesh (the tests) passes
``backend="gloo"``.  Nothing switches backend or device by itself.
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

from ..utils.errors import InvalidArgumentError
from ..utils.tensors import host_device
from .mesh import Sharding, _build, _placements, _require_group, from_global
from .streaming import axis_size

__all__ = ["init_distributed", "global_mesh", "channel_sharding",
           "stream_sharding", "stream_block", "make_global_array",
           "allgather", "process_count", "CHANNEL_AXES"]

# the packets/channels batch axis shards over both cross-node and
# within-node data parallelism
CHANNEL_AXES = ("host", "dp")


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None, *,
                     backend: str | None = None) -> bool:
    """Initialise the ``torch.distributed`` process group of this rank.

    Arguments default to torchrun's environment: ``MASTER_ADDR`` and
    ``MASTER_PORT`` (the coordinator ``host:port``), ``WORLD_SIZE`` and
    ``RANK``.  Returns True when a process group was initialised, False for
    a run of one process (no coordinator and no process count given).
    ``backend`` defaults to ``"nccl"`` (the CUDA card, which then must
    exist; the rank takes card ``LOCAL_RANK``, else ``process_id`` modulo
    the cards); pass ``"gloo"`` for CPU tensors, or for several ranks
    sharing one card.
    """
    env = os.environ
    if (coordinator_address is None and env.get("MASTER_ADDR")
            and env.get("MASTER_PORT")):
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if num_processes is None and env.get("WORLD_SIZE"):
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and env.get("RANK"):
        process_id = int(env["RANK"])
    if coordinator_address is None and num_processes is None:
        return False
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError(
            "init_distributed needs the coordinator address, the process "
            f"count and this process's id; got {coordinator_address!r}, "
            f"{num_processes!r}, {process_id!r}")
    if backend is None:
        host_device()           # NCCL needs the card: raises without one
        backend = "nccl"
    if backend == "nccl":
        local = env.get("LOCAL_RANK")
        torch.cuda.set_device(int(local) if local is not None
                              else process_id % torch.cuda.device_count())
    if "://" not in coordinator_address:
        coordinator_address = f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=coordinator_address,
                            world_size=num_processes, rank=process_id)
    return True


def process_count() -> int:
    """Ranks in the process group (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def global_mesh(dp: int | None = None, sp: int = 1, devices=None, *,
                device=None) -> DeviceMesh:
    """('host', 'dp', 'sp') mesh over ranks (default: every rank).

    ``host`` is the node: the ranks, sorted, are grouped by
    ``LOCAL_WORLD_SIZE`` (all of them are one host without it); ``dp`` and
    ``sp`` partition each host's ranks, ``dp`` defaulting to
    ranks-per-host // sp.  ``device`` as ``make_mesh`` takes it.  Raises
    ``ValueError`` when hosts*dp*sp != ranks.
    """
    _require_group()
    ranks = sorted(devices if devices is not None
                   else range(dist.get_world_size()))
    per_host = int(os.environ.get("LOCAL_WORLD_SIZE", len(ranks)))
    if per_host < 1 or len(ranks) % per_host:
        raise ValueError(f"{len(ranks)} ranks do not form hosts of "
                         f"LOCAL_WORLD_SIZE={per_host}")
    hosts = len(ranks) // per_host
    if dp is None:
        dp = per_host // sp
    if hosts * dp * sp != len(ranks):
        raise ValueError(
            f"hosts*dp*sp ({hosts}*{dp}*{sp}) != devices ({len(ranks)})")
    return _build(ranks, (hosts, dp, sp), ("host", "dp", "sp"), device)


def channel_sharding(mesh: DeviceMesh) -> Sharding:
    """Shard the leading packets/channels axis over host x dp (chunk
    host*dp_size + dp, as JAX's ``P(("host", "dp"))``); the sample axis and
    any trailing axes replicate: ``[Shard(0), Shard(0), Replicate()]``."""
    return _placements(mesh, {name: 0 for name in CHANNEL_AXES})


def stream_sharding(mesh: DeviceMesh) -> Sharding:
    """Shard a stream's time axis over 'sp' (within a node): Shard(-1)."""
    return _placements(mesh, {"sp": -1})


def stream_block(block_r, block_i, mesh: DeviceMesh,
                 axis: str = "sp") -> tuple[DTensor, DTensor]:
    """This rank's own time block of a stream as the stream DTensors that
    ``receive_stream`` and ``receive_stream_frames`` take with ``mesh`` and
    ``axis``: the deployment's entry, where each rank receives its block of
    the capture and no rank holds the whole stream.

    ``block_r``/``block_i`` are this rank's float32 (L,) planes, the
    ``k``-th of the stream's equal blocks for the rank at ``k`` on
    ``axis`` (replicated over the other mesh axes, as ``stream_sharding``
    places a stream).  They are wrapped in place: no copy, no collective.
    Raises ``InvalidArgumentError`` when the mesh has no ``axis``, or the
    planes are not 1-D, of one length, on the mesh's device; the
    receivers' halo gather raises it on every rank when the ranks' blocks
    differ in length.
    """
    axis_size(mesh, axis)
    if block_r.ndim != 1 or block_i.ndim != 1 \
            or block_r.shape != block_i.shape:
        raise InvalidArgumentError(
            f"a stream block is two 1-D planes of one length; got shapes "
            f"{tuple(block_r.shape)} and {tuple(block_i.shape)}")
    for x in (block_r, block_i):
        if x.device.type != mesh.device_type or (
                x.device.type == "cuda"
                and x.device.index != torch.cuda.current_device()):
            raise InvalidArgumentError(
                f"stream block on {x.device}: the mesh's ranks hold their "
                f"blocks on their own {mesh.device_type} device")
    placements = _placements(mesh, {axis: 0})
    return tuple(DTensor.from_local(x, mesh, placements, run_check=False)
                 for x in (block_r, block_i))


# A DTensor from host-replicated data: every rank computes the full array
# and keeps its own chunk; no collective runs (the channel-DP path must have
# none).  For data each rank computes identically (test fixtures,
# deterministic payload generators).
make_global_array = from_global


def allgather(x) -> np.ndarray:
    """Gather a sharded DTensor to host numpy on every rank."""
    return x.full_tensor().cpu().numpy()

"""Device meshes: data-parallel packet sharding over a ('dp', 'sp') mesh.

PyTorch port of ``lora_sdr_lightweight_standalone_library_clean_tpu/
parallel/mesh.py``.  The reference is single-threaded C; the parallel
dimensions latent in the workload are packets/channels (embarrassingly
parallel) and time blocks of a stream (sequential with overlap).  This
module owns the first: a mesh with a ``dp`` (packets/channels) axis and an
``sp`` (stream-block) axis, and the shardings that place a batch on it.

PyTorch's SPMD idiom stands where JAX's global arrays do: one rank per
device, a mesh is a ``torch.distributed`` ``DeviceMesh`` over the ranks of
an initialised process group (``parallel/distributed.py::
init_distributed``), a sharding is a list of DTensor placements (one per
mesh dimension) that carries its mesh, and a sharded array is a ``DTensor``
whose local tensor is this rank's chunk.  Placing data takes no
collective: every rank computes the full array and keeps its own chunk
(``DTensor.from_local``), so a batch sharded over ``dp`` runs the port's
ops on each rank's chunk with zero collectives.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..utils.tensors import host_device

__all__ = ["make_mesh", "packet_sharding", "shard_packets", "replicated"]


class Sharding(list):
    """DTensor placements, one per mesh dimension, with the mesh they apply
    to: the counterpart of a JAX ``NamedSharding``.  It is a list of
    placements, so it goes wherever DTensor takes placements."""

    def __init__(self, mesh: DeviceMesh, placements):
        super().__init__(placements)
        self.mesh = mesh


def _require_group() -> None:
    if not dist.is_initialized():
        raise RuntimeError(
            "a mesh spans the ranks of a torch.distributed process group: "
            "call parallel.distributed.init_distributed first")


def _build(ranks, shape, names, device) -> DeviceMesh:
    """A DeviceMesh of ``ranks`` reshaped to ``shape`` on ``device``'s type
    (the card unless the caller names the CPU)."""
    dev = host_device(device)
    _require_group()
    return DeviceMesh(dev.type, torch.tensor(ranks).reshape(shape),
                      mesh_dim_names=names)


def make_mesh(n_devices: int | None = None, dp: int | None = None,
              sp: int = 1, devices=None, *, device=None) -> DeviceMesh:
    """Build a ('dp', 'sp') mesh over ranks; with sp=1 this is pure data
    parallel.  ``devices`` is a list of ranks (default: every rank of the
    process group); ``device`` is where the ranks' tensors live: the CUDA
    card by default (raising without one), ``"cpu"`` on request.  Every
    rank of the process group calls it.  Raises ``ValueError`` when
    dp*sp != n_devices."""
    _require_group()
    if devices is None:
        devices = list(range(dist.get_world_size()))
    if n_devices is None:
        n_devices = len(devices)
    devices = list(devices)[:n_devices]
    if dp is None:
        dp = n_devices // sp
    if dp * sp != n_devices or len(devices) != n_devices:
        raise ValueError(f"dp*sp ({dp}*{sp}) != n_devices ({n_devices})"
                         f" over {len(devices)} ranks")
    return _build(devices, (dp, sp), ("dp", "sp"), device)


def _placements(mesh: DeviceMesh, sharded: dict) -> Sharding:
    """``Shard(sharded[name])`` on the named mesh dimensions, Replicate on
    the others."""
    return Sharding(mesh, [Shard(sharded[name]) if name in sharded
                           else Replicate() for name in mesh.mesh_dim_names])


def packet_sharding(mesh: DeviceMesh) -> Sharding:
    """Shard the leading packets/channels axis over 'dp', replicate the
    sample axis (``[Shard(0), Replicate()]`` on a ('dp', 'sp') mesh)."""
    return _placements(mesh, {"dp": 0})


def replicated(mesh: DeviceMesh) -> Sharding:
    return _placements(mesh, {})


def from_global(global_data, sharding: Sharding) -> DTensor:
    """This rank's chunk of host-replicated data as a DTensor: every rank
    passes the same full array, each keeps its own chunk on the mesh's
    device, and no collective runs.  Sharded dimensions must divide evenly
    (as JAX requires of a global array)."""
    mesh = sharding.mesh
    x = (global_data if isinstance(global_data, torch.Tensor)
         else torch.as_tensor(np.asarray(global_data)))
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this rank is not in the mesh")
    placements = []
    for mdim, pl in enumerate(sharding):
        if isinstance(pl, Shard):
            dim = pl.dim % x.ndim
            parts = mesh.size(mdim)
            if x.shape[dim] % parts:
                raise ValueError(
                    f"dimension {dim} of size {x.shape[dim]} does not split "
                    f"evenly over the {parts} ranks of mesh dimension "
                    f"{mesh.mesh_dim_names[mdim]!r}")
            size = x.shape[dim] // parts
            x = x.narrow(dim, coord[mdim] * size, size)
            pl = Shard(dim)
        placements.append(pl)
    # a copy, so the chunk holds neither the caller's array nor the full
    # tensor alive
    local = x.contiguous().to(mesh.device_type, copy=True)
    return DTensor.from_local(local, mesh, placements, run_check=False)


def shard_packets(x, mesh: DeviceMesh) -> DTensor:
    """Place a (batch, ...) array with its batch axis sharded over 'dp'."""
    return from_global(x, packet_sharding(mesh))

"""Streaming detection over a continuous IQ stream, on one device or
sharded over a device mesh.

PyTorch port of ``lora_sdr_lightweight_standalone_library_clean_tpu/
parallel/streaming.py``: every ``stride``-aligned window of the stream is
dechirped and detected (``stream_scan``), and the two sync symbols of a
packet are recognised in the detections (``find_sync_starts`` for aligned
packets, ``find_packet_starts`` at arbitrary sample offsets).

The per-window work is ``ops/cuda_stream.py::stream_window_detect``: a
CUDA tensor launches the streaming-scan kernel (#7), a CPU tensor runs its
plain version.  The window past the end of the stream reads zeros, which is
the JAX package's one-device halo of ``step`` zeros (``streaming.py:
205-209``).

With a mesh (``parallel/mesh.py``) the stream is a DTensor whose time axis
is sharded over the mesh axis ``axis``: each rank scans the windows that
start in its block (deterministic ownership).  The windows that cross the
block's right edge read a halo of ``step`` samples from the next ranks;
the last rank reads zeros.  JAX's ``ppermute`` of the halo becomes one
``all_gather`` of every rank's leading samples over the ``axis`` group,
from which each rank takes its right neighbours': the one collective that
runs the same on gloo (CPU or CUDA tensors) and NCCL.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..ops.chirp import downchirp_ri
from ..ops.cuda_stream import stream_window_detect
from ..utils.config import LoraParams
from ..utils.errors import InvalidArgumentError
from ..utils.spans import count, span

__all__ = ["StreamScan", "stream_scan", "find_sync_starts",
           "find_packet_starts"]


class StreamScan(NamedTuple):
    """Per window detection over the stream (leading axes preserved).

    ``index[..., w]``/``power[..., w]`` describe the window starting at
    sample ``w * stride``."""

    index: torch.Tensor       # int32 first-max bin
    power: torch.Tensor       # fundamental power, dB
    power_avg: torch.Tensor   # noise floor, dB


def _scan_downchirp(params: LoraParams) -> tuple[np.ndarray, np.ndarray]:
    """Down-chirp for the decimated scan grid: the full-rate base
    down-chirp sampled at the phase-0 decimation points.

    At osr > 1 the osr=1 down-chirp is NOT the conjugate of the decimated
    base up-chirp: the reference's genChirp phase at oversampled index
    m = i*osr carries a residual linear term from its m*(m+1) numerator, so
    dechirping decimated windows with the osr=1 chirp leaves a
    -bs*(osr-1)/(2*osr)-bin tone offset.  The decimated full-rate
    down-chirp cancels the phase exactly, leaving a pure integer-bin tone
    (sym*bs) mod n.  At osr == 1 this IS downchirp_ri(sf, bs)."""
    dcr, dci = downchirp_ri(params.sf, params.bw_scale, params.osr)
    return (np.ascontiguousarray(dcr[::params.osr]),
            np.ascontiguousarray(dci[::params.osr]))


def _stride_windows(ext, total: int, step: int, stride: int, n: int,
                    osr: int):
    """All stride-aligned decimated windows of ``ext``, gather-free.

    Stride-aligned windows are regular: phase j (j in [0, step/stride))
    windows are a plain reshape of ``ext[j*stride:]``.  The phases are
    interleaved back so window w corresponds to start w*stride; samples
    past the end of ``ext`` are zeros.  Output (..., W, n) where
    W = total // stride.
    """
    phases = step // stride
    windows = total // stride
    per = -(-windows // phases)       # step-aligned windows per phase
    need = (phases - 1) * stride + per * step
    if need > ext.shape[-1]:
        ext = torch.nn.functional.pad(ext, (0, need - ext.shape[-1]))
    cols = []
    for j in range(phases):
        sl = ext[..., j * stride:j * stride + per * step]
        cols.append(sl.reshape(sl.shape[:-1] + (per, n, osr))[..., 0])
    # (..., per, phases, n) -> (..., W, n) with w = p*phases + j
    stacked = torch.stack(cols, dim=-2)
    all_w = stacked.reshape(stacked.shape[:-3] + (per * phases, n))
    return all_w[..., :windows, :]


def _all_gather(x, mesh: DeviceMesh, axis: str, kind: str) -> list:
    """``dist.all_gather`` of ``x`` over the ranks of ``axis``, in their
    order; adds the bytes of ``x`` to ``COUNTS["collective_bytes.<kind>"]``
    (``utils/spans.py``).

    The kinds are what a collective carries: ``halo`` (the leading and
    trailing samples of this rank's block), ``scan`` (its windows'
    detections, gathered before the packet search), ``results`` (the
    decoded fields of the packets it owns).  An all_gather counts this
    rank's contribution, an all_reduce its buffer.  The collective runs
    in the span ``lora.rx.collective.<kind>``."""
    out = [torch.empty_like(x)
           for _ in range(axis_size(mesh, axis))]
    x = x.contiguous()
    with span("lora.rx.collective." + kind):
        dist.all_gather(out, x, group=mesh.get_group(axis))
    count("collective_bytes." + kind, x.numel() * x.element_size())
    return out


def all_reduce(x, mesh: DeviceMesh, axis: str, kind: str) -> None:
    """In-place sum of ``x`` over the ranks of ``axis``; adds its bytes to
    ``COUNTS["collective_bytes.<kind>"]``, in the span
    ``lora.rx.collective.<kind>`` (``_all_gather``)."""
    axis_size(mesh, axis)
    with span("lora.rx.collective." + kind):
        dist.all_reduce(x, group=mesh.get_group(axis))
    count("collective_bytes." + kind, x.numel() * x.element_size())


def axis_size(mesh, axis: str) -> int:
    """The ranks on ``axis`` of ``mesh``; raises unless ``mesh`` is a
    DeviceMesh that has that axis."""
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a torch.distributed DeviceMesh "
                        f"(parallel/mesh.py), got {type(mesh).__name__}")
    if axis not in mesh.mesh_dim_names:
        raise InvalidArgumentError(
            f"mesh axes {mesh.mesh_dim_names} have no {axis!r}")
    return mesh.size(mesh.mesh_dim_names.index(axis))


def local_block(x, mesh: DeviceMesh, axis: str):
    """This rank's block of a stream DTensor sharded on its last dimension
    over ``axis`` (and replicated over the other mesh axes); raises on any
    other layout."""
    axis_size(mesh, axis)
    dim = mesh.mesh_dim_names.index(axis)
    if not isinstance(x, DTensor) or x.device_mesh != mesh:
        raise InvalidArgumentError(
            "with a mesh, the stream planes are DTensors on that mesh "
            "(parallel/distributed.py::stream_block, or make_global_array "
            "with stream_sharding)")
    want = [Shard(x.ndim - 1) if d == dim else Replicate()
            for d in range(mesh.ndim)]
    if list(x.placements) != want:
        raise InvalidArgumentError(
            f"stream placements {tuple(x.placements)}: expected "
            f"{tuple(want)} (the time axis sharded over {axis!r})")
    return x.to_local()


def following(leads: list, me: int, width: int):
    """The ``width`` samples after rank ``me``'s block, from every rank's
    leading samples ``leads`` (in rank order, each (..., w) with w <= its
    block): the next ranks' concatenated, zeros past the last rank.  A
    block shorter than ``width`` reads several neighbours."""
    ctx = torch.cat(leads[me + 1:] + [leads[me][..., :0]],
                    dim=-1)[..., :width]
    return torch.nn.functional.pad(ctx, (0, width - ctx.shape[-1]))


def stream_scan(iq_r, iq_i, params: LoraParams, mesh=None, axis: str = "sp",
                stride: int | None = None,
                backend: str = "auto") -> StreamScan:
    """Dechirp-detect every ``stride``-aligned window of a continuous stream.

    ``stride`` defaults to a full symbol; a sub-symbol stride (e.g. step//2)
    finds packets at arbitrary half-symbol alignments: those windows cross
    block boundaries, which is what the halo covers.  The stream length
    must be a multiple of ``stride``; the windows that start in the stream
    and run past its end read zeros.  Leading axes are independent streams.

    With a mesh (a ``DeviceMesh``), ``iq_r``/``iq_i`` are DTensors whose
    last axis is sharded over ``axis``, the number of windows must divide
    evenly over its ranks (else ``ValueError``), each rank scans the
    windows that start in its block, and the outputs are DTensors sharded
    like the input: their ``full_tensor()`` is the one-device scan.
    Without a mesh, the identical computation on one device.

    ``backend`` takes the JAX package's kernel values, ``"auto"`` and
    ``"pallas"`` (the scan kernel on a CUDA tensor, its plain version on a
    CPU tensor); any other value raises, since a CPU tensor is the plain
    route and there is no ``"jnp"`` one.
    """
    if backend not in ("auto", "pallas"):
        raise InvalidArgumentError(
            f"backend {backend!r}: the port's stream scan routes are 'auto' "
            "and 'pallas' (the scan kernel); a CPU tensor runs its plain "
            "version, so there is no 'jnp' route")
    step = params.step
    if stride is None:
        stride = step
    total = iq_r.shape[-1]
    if total % stride != 0:
        raise ValueError(
            f"stream length {total} not a multiple of stride {stride}")
    if mesh is None:
        if isinstance(iq_r, DTensor):
            raise InvalidArgumentError(
                "a DTensor stream is scanned with its mesh: pass mesh=")
        idx, p, pav = stream_window_detect(iq_r.contiguous(),
                                           iq_i.contiguous(), params,
                                           stride, total // stride)
        return StreamScan(idx, p, pav)

    n_shards = axis_size(mesh, axis)
    if (total // stride) % n_shards != 0:
        raise ValueError(
            f"{total // stride} windows not divisible by {n_shards} shards")
    br = local_block(iq_r, mesh, axis)
    bi = local_block(iq_i, mesh, axis)
    block = br.shape[-1]
    w = min(step, block)
    leads = _all_gather(torch.stack([br[..., :w], bi[..., :w]]), mesh, axis,
                        "halo")
    halo = following(leads, mesh.get_local_rank(axis), step)
    out = stream_window_detect(torch.cat([br, halo[0]], dim=-1),
                               torch.cat([bi, halo[1]], dim=-1), params,
                               stride, block // stride)
    return StreamScan(*(DTensor.from_local(t, mesh, iq_r.placements,
                                           run_check=False) for t in out))


def _shift_back(x, k: int):
    """x[..., w + k], zero (False) past the end."""
    out = torch.zeros_like(x)
    if k < x.shape[-1]:
        out[..., :x.shape[-1] - k] = x[..., k:]
    return out


def _strong(scan: StreamScan, power_gate_db: float, noise_floor_db: float):
    """Power above the noise floor by the gate, both clamped to
    ``noise_floor_db`` first: a dead window (all-zero samples, -inf dB on
    both sides) scores 0 dB and never passes."""
    p = torch.clamp(scan.power, min=noise_floor_db)
    pav = torch.clamp(scan.power_avg, min=noise_floor_db)
    return (p - pav) > power_gate_db


def find_sync_starts(scan: StreamScan, params: LoraParams,
                     power_gate_db: float = 10.0,
                     stride: int | None = None,
                     noise_floor_db: float = -200.0) -> torch.Tensor:
    """Boolean mask of windows that look like the start of a packet's sync
    prelude: two sync-symbol detections one symbol apart matching the
    configured sync-word nibbles, with fundamental power above the noise
    floor by ``power_gate_db``.  ``stride`` must match the stream_scan call
    (default: one symbol)."""
    step = params.step
    if stride is None:
        stride = step
    hop = step // stride  # windows per symbol
    sw0, sw1 = params.sync_nibble_symbols()
    bs, n = params.bw_scale, params.n
    strong = _strong(scan, power_gate_db, noise_floor_db)
    m0 = (scan.index == (sw0 * bs) % n) & strong
    m1 = (scan.index == (sw1 * bs) % n) & strong
    return m0 & _shift_back(m1, hop)


def find_packet_starts(scan: StreamScan, params: LoraParams,
                       stride: int | None = None,
                       power_gate_db: float = 5.0,
                       noise_floor_db: float = -200.0,
                       dedupe_tol: int = 2,
                       max_mis: int | None = None):
    """Sync detection for packets at *arbitrary* sample offsets.

    A chirp misaligned by ``d`` samples dechirps to a tone shifted by ``d``
    bins, so the signature is the *bin difference* of the two consecutive
    sync symbols, invariant to the shared misalignment, and the
    misalignment itself is read off the first sync bin:

        d    = signed_mod(idx - sw0*bs, n) * osr // bs   (samples)
        start = window_pos - d

    Windows adjacent to a true start flag with the same corrected
    position; consecutive duplicates (within ``dedupe_tol`` samples) keep
    only the first.  ``max_mis`` (samples) drops flags whose measured
    misalignment exceeds it (the wide receiver's alias guard, JAX
    ``streaming.py:308-315``).  ``%`` and ``//`` are floor operations on
    negative residues, as in the JAX package.

    Returns:
      (keep, start): boolean mask over windows and int64 corrected start
      positions in samples (valid where ``keep``).
    """
    step = params.step
    if stride is None:
        stride = max(step // 4, 1)
    hop = step // stride
    sw0, sw1 = params.sync_nibble_symbols()
    bs, n = params.bw_scale, params.n
    idx = scan.index.to(torch.int64)
    strong = _strong(scan, power_gate_db, noise_floor_db)

    want_diff = ((sw1 - sw0) * bs) % n
    diff = torch.remainder(_shift_back(idx, hop) - idx, n)
    flagged = strong & _shift_back(strong, hop) & (diff == want_diff)

    # misalignment from the first sync bin, as a signed mod-n residue;
    # multiply by osr BEFORE the floor division so the correction is
    # sample-exact whenever bs divides osr * d_bins
    d_bins = torch.remainder(idx - sw0 * bs, n)
    d_signed = torch.where(d_bins > n // 2, d_bins - n, d_bins)
    d_samples = torch.div(d_signed * params.osr, bs, rounding_mode="floor")
    if max_mis is not None:
        flagged = flagged & (torch.abs(d_samples) <= max_mis)
    w = torch.arange(idx.shape[-1], dtype=torch.int64,
                     device=idx.device) * stride
    start = w - d_samples

    # drop duplicate flags of the same packet at the neighbouring window
    prev_flag = torch.zeros_like(flagged)
    prev_flag[..., 1:] = flagged[..., :-1]
    prev_start = torch.zeros_like(start)
    prev_start[..., 1:] = start[..., :-1]
    dup = prev_flag & (torch.abs(start - prev_start) <= dedupe_tol)
    return flagged & ~dup, start

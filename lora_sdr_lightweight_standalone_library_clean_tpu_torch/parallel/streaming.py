"""Streaming detection over a continuous IQ stream.

PyTorch port of ``lora_sdr_lightweight_standalone_library_clean_tpu/
parallel/streaming.py`` on one device: every ``stride``-aligned window of
the stream is dechirped and detected (``stream_scan``), and the two sync
symbols of a packet are recognised in the detections (``find_sync_starts``
for aligned packets, ``find_packet_starts`` at arbitrary sample offsets).

The per-window work is ``ops/cuda_stream.py::stream_window_detect``: a
CUDA tensor launches the streaming-scan kernel (#7), a CPU tensor runs its
plain version.  The window past the end of the stream reads zeros, which is
the JAX package's one-device halo of ``step`` zeros (``streaming.py:
205-209``).  The JAX package's ``mesh``/``axis`` arguments, which shard the
scan with ``ppermute`` halos, wait for the port's ``torch.distributed``
layer and are not taken here.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.chirp import downchirp_ri
from ..ops.cuda_stream import stream_window_detect
from ..utils.config import LoraParams

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


def stream_scan(iq_r, iq_i, params: LoraParams,
                stride: int | None = None) -> StreamScan:
    """Dechirp-detect every ``stride``-aligned window of a continuous stream.

    ``stride`` defaults to a full symbol; a sub-symbol stride (e.g. step//2)
    finds packets at arbitrary half-symbol alignments.  The stream length
    must be a multiple of ``stride``; the windows that start in the stream
    and run past its end read zeros.  Leading axes are independent streams.
    """
    step = params.step
    if stride is None:
        stride = step
    total = iq_r.shape[-1]
    if total % stride != 0:
        raise ValueError(
            f"stream length {total} not a multiple of stride {stride}")
    idx, p, pav = stream_window_detect(iq_r.contiguous(), iq_i.contiguous(),
                                       params, stride, total // stride)
    return StreamScan(idx, p, pav)


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

"""End-to-end streaming RX: continuous IQ stream -> decoded payloads.

PyTorch port of ``lora_sdr_lightweight_standalone_library_clean_tpu/
parallel/receiver.py`` (its fixed-length receiver).  The reference's
``demodulate`` takes one caller-aligned packet (``src/phy/phy.cpp:
182-243``); this module takes chunks of a continuous multi-packet stream:

  chunk of stream -> stream scan (``parallel/streaming.py``, kernel #7 on
  the card) -> deterministic candidate selection -> extraction of each
  packet -> dechirp -> ``demodulate_tones`` (or ``demodulate_wide``) ->
  ``decode``, batched over the found packets -> payloads + CRC verdicts +
  positions.

**Chunk boundaries.**  A ``StreamRxState`` carries the last ``packet_len``
raw samples.  A packet is recovered by the first chunk in which its whole
body is available: chunk k (providing samples up to E_k = offset + k*L)
owns sync starts g with E_{k-1} < g + packet_len <= E_k.  Ownership is a
partition, so no packet is recovered twice, none is lost, and results do
not depend on how the stream is chunked.

``max_packets`` bounds the recovery per chunk (the earliest starts win; a
saturated chunk shows in ``n_dropped``), ``payload_symbols`` fixes the
packet length, and absent packets are masked by ``valid``.  At bw_scale > 1
the packets decode through the injective wide receiver
(``demodulate_wide``, on by default when osr >= bw_scale).

The JAX package counts samples in int32 (its offset wraps after 2^31
samples, about 4.8 hours at 125 kHz); the port counts them in int64.  The
JAX package's ``mesh``/``axis`` sharding of the scan waits for the port's
``torch.distributed`` layer, and ``receive_stream_frames`` (variable-length
frames) for its ``models/frame.py``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..models.modem import decode, dechirp, demodulate_wide
from ..models.tones import demodulate_tones
from ..utils.config import LoraParams
from ..utils.errors import InvalidArgumentError
from ..utils.tensors import host_device
from .streaming import find_packet_starts, stream_scan

__all__ = ["StreamRxState", "RecoveredPackets", "stream_rx_init",
           "receive_stream", "packet_samples"]


class StreamRxState(NamedTuple):
    """Carried state between successive chunks of one logical stream."""

    tail_r: torch.Tensor     # (packet_len,) last raw samples of prev chunk
    tail_i: torch.Tensor
    offset: torch.Tensor     # int64 global sample index of the next chunk


class RecoveredPackets(NamedTuple):
    """Up to ``max_packets`` packets recovered from one chunk."""

    payload: torch.Tensor    # (K, bytes) uint8
    crc_ok: torch.Tensor     # (K,) bool
    valid: torch.Tensor      # (K,) bool: entry k holds a real packet
    start: torch.Tensor      # (K,) int64 global sample index of sync start
    sync_word: torch.Tensor  # (K,) uint8
    cfo: torch.Tensor        # (K,) float32
    time_offset: torch.Tensor   # (K,) float32
    n_candidates: torch.Tensor  # () int32 sync starts owned by this chunk
    n_dropped: torch.Tensor     # () int32 owned starts beyond max_packets


def packet_samples(params: LoraParams, payload_symbols: int) -> int:
    """Samples per packet: 2 sync + payload symbols (LoRaMod.cpp:42)."""
    return (payload_symbols + 2) * params.step


def stream_rx_init(params: LoraParams, payload_symbols: int,
                   device=None) -> StreamRxState:
    """Fresh state: a zero tail (no samples seen yet), on ``device`` (the
    CUDA card unless the caller names another, ``utils/tensors.py::
    host_device``)."""
    dev = host_device(device)
    plen = packet_samples(params, payload_symbols)
    return StreamRxState(
        tail_r=torch.zeros(plen, dtype=torch.float32, device=dev),
        tail_i=torch.zeros(plen, dtype=torch.float32, device=dev),
        offset=torch.zeros((), dtype=torch.int64, device=dev),
    )


def _resolve_wide(params: LoraParams, wide: bool | None) -> bool:
    """``None`` turns the injective wide receiver on exactly when it is both
    needed and possible: bw_scale > 1 (the reference's decimating detector
    loses the top log2(bw_scale) symbol bits there) and osr >= bw_scale.
    ``True`` forces it (raising when osr is too low); ``False`` keeps the
    reference-faithful decimating tones path."""
    if wide is None:
        return params.bw_scale > 1 and params.osr >= params.bw_scale
    if wide and params.osr < params.bw_scale:
        raise InvalidArgumentError(
            f"wide streaming RX needs osr >= bw_scale "
            f"({params.osr} < {params.bw_scale})")
    return wide


def _default_stride(params: LoraParams, wide: bool) -> int:
    """A quarter symbol, shrunk by bw_scale in wide mode so the sync-bin
    misalignment residue stays within +-n/4 bins (a bs-scaled chirp shifts
    bs bins per decimated sample)."""
    div = 4 * (params.bw_scale if wide else 1)
    return max(params.step // div, 1)


def _wide_max_mis(params: LoraParams, stride: int) -> int:
    """Misalignment bound for wide-mode sync flags: a true start's nearest
    window lies within stride/2, plus slack for +-1-bin residue rounding
    (osr/bs samples per bin).  Kills period-n*osr/bs aliases."""
    return stride // 2 + max(8, 4 * params.osr // params.bw_scale)


def _owned_starts(ext_r, ext_i, chunk_len: int, plen: int,
                  params: LoraParams, stride: int, power_gate_db: float,
                  max_packets: int, dedupe_tol: int = 2,
                  max_mis: int | None = None):
    """Scan [tail | chunk] and pick this chunk's owned packet starts.

    Ownership: corrected starts g with 0 < g <= chunk_len (ext coordinates
    shifted by plen): the packet's last sample arrived in this chunk and
    not before.  Returns the earliest ``max_packets`` starts ascending
    (clamped for extraction), their validity mask, and the owned-candidate
    count.  The sentinel ext_len + 1 fills the places of absent packets; a
    tie between sentinels is harmless.
    """
    ext_len = plen + chunk_len
    scan = stream_scan(ext_r, ext_i, params, stride=stride)
    mask, start = find_packet_starts(scan, params, stride=stride,
                                     power_gate_db=power_gate_db,
                                     dedupe_tol=dedupe_tol, max_mis=max_mis)
    owned = mask & (start > 0) & (start <= chunk_len)
    sentinel = ext_len + 1
    cand = torch.where(owned, start, sentinel)
    starts = torch.topk(cand, max_packets, largest=False, sorted=True).values
    valid = starts < sentinel
    starts_c = torch.clamp(torch.where(valid, starts, 0), 0, ext_len - plen)
    return starts_c, valid, owned.sum(dtype=torch.int32)


def receive_stream(iq_r, iq_i, params: LoraParams, *,
                   payload_symbols: int, max_packets: int,
                   state: StreamRxState | None = None,
                   stride: int | None = None,
                   power_gate_db: float = 5.0,
                   wide: bool | None = None,
                   ) -> tuple[RecoveredPackets, StreamRxState]:
    """Recover every whole packet that completes inside this chunk.

    Args:
      iq_r/iq_i: float32 (L,) tensors, a chunk of the continuous stream; L
        must be a multiple of ``stride``.  The chunk's device decides the
        path: a CUDA chunk runs the kernels, a CPU chunk the plain versions.
      payload_symbols: data symbols per packet.
      max_packets: recovery capacity per chunk.  If more packets complete
        in a chunk, the earliest ``max_packets`` win.
      state: carried state from the previous chunk (None = stream start).
      stride: scan granularity in samples (default: a quarter symbol,
        divided by bw_scale in wide mode).  Packets at arbitrary sample
        offsets are recovered exactly: the sync-bin shift measures the
        window misalignment, which corrects the extraction to the true
        start.
      power_gate_db: sync-window power above the noise floor.
      wide: decode through the injective full-rate receiver
        (``demodulate_wide``) instead of the decimating tones path; ``None``
        (default) turns it on when bw_scale > 1 and osr >= bw_scale.

    Returns:
      (RecoveredPackets, new StreamRxState).
    """
    wide = _resolve_wide(params, wide)
    if stride is None:
        stride = _default_stride(params, wide)
    if iq_r.ndim != 1:
        raise InvalidArgumentError(
            f"receive_stream takes one stream, float32 (L,) planes; got "
            f"shape {tuple(iq_r.shape)}")
    chunk_len = iq_r.shape[-1]
    if chunk_len % stride:
        raise ValueError(f"chunk length {chunk_len} not a multiple of "
                         f"stride {stride}")
    plen = packet_samples(params, payload_symbols)
    if plen % stride:
        raise ValueError(f"packet length {plen} not a multiple of "
                         f"stride {stride}")
    if state is None:
        state = stream_rx_init(params, payload_symbols, device=iq_r.device)

    # extended stream: [prev tail | chunk]; ext position p <-> global
    # sample g = p + offset - plen
    ext_r = torch.cat([state.tail_r, iq_r])
    ext_i = torch.cat([state.tail_i, iq_i])

    starts_c, valid, n_candidates = _owned_starts(
        ext_r, ext_i, chunk_len, plen, params, stride, power_gate_db,
        max_packets, dedupe_tol=max(2, params.osr) if wide else 2,
        max_mis=_wide_max_mis(params, stride) if wide else None)

    # each packet is a row of the overlapping (ext_len - plen + 1, plen)
    # view of the stream: one gather of K * plen samples
    pkt_r = ext_r.unfold(0, plen, 1).index_select(0, starts_c)
    pkt_i = ext_i.unfold(0, plen, 1).index_select(0, starts_c)
    dr, di = dechirp(pkt_r, pkt_i, params)
    res = (demodulate_wide if wide else demodulate_tones)(dr, di, params)
    payload, crc_ok = decode(res.symbols)

    packets = RecoveredPackets(
        payload=torch.where(valid[:, None], payload,
                            torch.zeros_like(payload)),
        crc_ok=crc_ok & valid,
        valid=valid,
        start=starts_c + state.offset - plen,
        sync_word=torch.where(valid, res.sync_word,
                              torch.zeros_like(res.sync_word)),
        cfo=torch.where(valid, res.cfo, torch.zeros_like(res.cfo)),
        time_offset=torch.where(valid, res.time_offset,
                                torch.zeros_like(res.time_offset)),
        n_candidates=n_candidates,
        n_dropped=torch.clamp(n_candidates - max_packets, min=0),
    )
    new_state = StreamRxState(
        tail_r=ext_r[chunk_len:].clone(),            # last plen samples
        tail_i=ext_i[chunk_len:].clone(),
        offset=state.offset + chunk_len,
    )
    return packets, new_state

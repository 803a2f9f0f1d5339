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

``receive_stream_frames`` is the header-driven receiver for traffic of
mixed lengths: the same scan, ownership and extraction with every packet
taken at its maximal frame length, then ``models/frame.py::
decode_frame_padded`` reads each frame's explicit header and recovers its
advertised length, up to ``max_payload_len``.

**Shard boundaries.**  With a mesh, a chunk is a DTensor whose time axis
is sharded over the mesh axis ``axis`` (``sp``); rank 0 of that axis
prepends the carried tail, so each rank holds one block of [tail | chunk].
Each rank scans the windows that start in its block (``parallel/
streaming.py``; the windows that cross its right edge read the next
ranks' leading samples), and the scan's three outputs, 12 B a window, are
gathered over ``axis``, so every rank picks the same owned starts from the
same global detections, exactly as on one device.  Each rank then
extracts, demodulates and decodes only the packets whose start lies in its
block, reading up to ``plen - 1`` samples past it from the next ranks'
leading ``min(plen, block)`` samples (so a block shorter than a packet
works), and only the decoded fields go back into the K slots (an
all_reduce over ``axis``): no rank gathers the stream or the packet
bodies.  Every rank returns the one-device result, and the new state's
tail, gathered from the ranks that hold the last ``plen`` samples, is the
same on every rank.  Three collectives a chunk, whose bytes
``COUNTS["collective_bytes.<halo|scan|results>"]`` counts
(``utils/spans.py``).

**Stages.**  Under a ``torch.profiler`` session each call is the span
``lora.receive_stream`` (``lora.receive_stream_frames``) holding, in order,
``lora.rx.extend`` ([tail | chunk], the halo gather on a mesh),
``lora.rx.scan``, ``lora.rx.select`` (start finding, ownership, the first
``max_packets``), ``lora.rx.extract`` (the packets' rows and their
dechirp, one kernel on the card: ``ops/cuda_extract.py``), the
demodulator's ``lora.rx.demod``, the decoder's ``lora.codec.*`` and
``lora.rx.outputs`` (the masked records and the new state).

The JAX package counts samples in int32 (its offset wraps after 2^31
samples, about 4.8 hours at 125 kHz); the port counts them in int64.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch.distributed.tensor import DTensor

from ..models import frame as frame_codec
from ..models.modem import decode, demodulate_wide
from ..models.tones import demodulate_tones
from ..utils.config import LoraParams
from ..utils.errors import InvalidArgumentError
from ..utils.spans import span, spanned
from ..utils.tensors import host_device
from ..ops.cuda_extract import extract_dechirp
from ..ops.cuda_stream import stream_window_detect
from .streaming import (StreamScan, _all_gather, all_reduce, axis_size,
                        find_packet_starts, following, local_block,
                        stream_scan)

__all__ = ["StreamRxState", "RecoveredPackets", "RecoveredFrames",
           "stream_rx_init", "stream_frames_init",
           "receive_stream", "receive_stream_frames", "packet_samples"]


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
    return _zero_state(packet_samples(params, payload_symbols),
                       host_device(device))


def _zero_state(plen: int, dev) -> StreamRxState:
    return StreamRxState(
        tail_r=torch.zeros(plen, dtype=torch.float32, device=dev),
        tail_i=torch.zeros(plen, dtype=torch.float32, device=dev),
        offset=torch.zeros((), dtype=torch.int64, device=dev),
    )


class RecoveredFrames(NamedTuple):
    """Up to ``max_packets`` variable-length frames from one chunk."""

    payload: torch.Tensor    # (K, max_payload_len) uint8, zero past length
    length: torch.Tensor     # (K,) int32 payload bytes from each header
    hdr_ok: torch.Tensor     # (K,) bool explicit-header checksum verdict
    crc_ok: torch.Tensor     # (K,) bool payload CRC verdict
    valid: torch.Tensor      # (K,) bool: entry k holds a real detection
    start: torch.Tensor      # (K,) int64 global sample index of sync start
    sync_word: torch.Tensor  # (K,) uint8
    cfo: torch.Tensor        # (K,) float32
    time_offset: torch.Tensor   # (K,) float32
    n_err: torch.Tensor      # (K,) int32 FEC-corrected codewords
    n_candidates: torch.Tensor  # () int32 sync starts owned by this chunk
    n_dropped: torch.Tensor     # () int32 owned starts beyond max_packets


def stream_frames_init(params: LoraParams, max_payload_len: int,
                       crc: bool = True, device=None) -> StreamRxState:
    """Fresh state for ``receive_stream_frames`` (a max-frame-sized tail),
    on ``device`` as ``stream_rx_init`` places it."""
    s_max = frame_codec.max_frame_symbols(params, max_payload_len, crc)
    return stream_rx_init(params, s_max, device=device)


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


class _Ext(NamedTuple):
    """This rank's part of the extended stream [tail | chunk]."""

    r: torch.Tensor      # its samples, then the samples that follow them
    i: torch.Tensor
    lo: int              # ext position of its first sample
    owned: int           # the samples it owns, r[:owned]


def _extend(iq_r, iq_i, state, plen: int, mesh, axis: str):
    """[tail | chunk] as this rank holds it, and the new state's tail planes
    (the last ``plen`` samples of [tail | chunk]).

    One device: the whole of it.  With a mesh: this rank's block (rank 0 of
    ``axis`` prepends the tail), followed by the next ranks' leading
    ``plen`` samples; one all_gather of every block's leading and trailing
    ``min(plen, block)`` samples gives both those and the new tail."""
    if mesh is None:
        ext_r = torch.cat([state.tail_r, iq_r])
        ext_i = torch.cat([state.tail_i, iq_i])
        n = ext_r.shape[-1]
        return (_Ext(ext_r, ext_i, 0, n), ext_r[n - plen:].clone(),
                ext_i[n - plen:].clone())
    br = local_block(iq_r, mesh, axis)
    bi = local_block(iq_i, mesh, axis)
    block = br.shape[-1]
    w = min(plen, block)
    edges = torch.stack([br[:w], bi[:w], br[block - w:], bi[block - w:]])
    got = _all_gather(edges, mesh, axis, "halo")
    me = mesh.get_local_rank(axis)
    ctx = following([g[:2] for g in got], me, plen)
    tail = torch.stack([state.tail_r, state.tail_i])
    new_tail = torch.cat([tail] + [g[2:] for g in got], dim=-1)[:, -plen:]
    own = torch.stack([br, bi])
    lo = plen + me * block
    if me == 0:
        own, lo = torch.cat([tail, own], dim=-1), 0
    ext = torch.cat([own, ctx], dim=-1)
    return (_Ext(ext[0], ext[1], lo, own.shape[-1]), new_tail[0].clone(),
            new_tail[1].clone())


def _gathered_scan(ext: _Ext, plen: int, params: LoraParams, mesh,
                   axis: str, stride: int) -> StreamScan:
    """The scan of every window of [tail | chunk] on every rank: each rank
    scans the windows that start in its block, and the three outputs (12 B
    a window, bit patterns in int32 words) are all-gathered over ``axis``;
    rank 0's block is ``plen`` samples longer, so every contribution is
    padded to its size."""
    idx, p, pav = stream_window_detect(ext.r, ext.i, params, stride,
                                       ext.owned // stride)
    me = mesh.get_local_rank(axis)
    block = ext.owned - (plen if me == 0 else 0)
    packed = torch.stack([idx, p.view(torch.int32), pav.view(torch.int32)])
    packed = torch.nn.functional.pad(
        packed, (0, (plen + block) // stride - packed.shape[-1]))
    got = _all_gather(packed, mesh, axis, "scan")
    full = torch.cat([got[0]] + [g[:, :block // stride] for g in got[1:]],
                     dim=-1)
    return StreamScan(full[0], full[1].view(torch.float32),
                      full[2].view(torch.float32))


def _owned_starts(ext: _Ext, chunk_len: int, plen: int, params: LoraParams,
                  mesh, axis: str, stride: int, power_gate_db: float,
                  max_packets: int, dedupe_tol: int = 2,
                  max_mis: int | None = None):
    """Scan [tail | chunk] and pick this chunk's owned packet starts.

    Ownership: corrected starts g with 0 < g <= chunk_len (ext coordinates
    shifted by plen): the packet's last sample arrived in this chunk and
    not before.  Starts are global ext positions on every rank, whatever
    the mesh.  Returns the earliest ``max_packets`` starts ascending
    (clamped for extraction), their validity mask, and the owned-candidate
    count.  The sentinel ext_len + 1 fills the places of absent packets; a
    tie between sentinels is harmless.
    """
    ext_len = plen + chunk_len
    with span("lora.rx.scan"):
        if mesh is None:
            scan = stream_scan(ext.r, ext.i, params, stride=stride)
        else:
            scan = _gathered_scan(ext, plen, params, mesh, axis, stride)
    with span("lora.rx.select"):
        mask, start = find_packet_starts(scan, params, stride=stride,
                                         power_gate_db=power_gate_db,
                                         dedupe_tol=dedupe_tol,
                                         max_mis=max_mis)
        owned = mask & (start > 0) & (start <= chunk_len)
        sentinel = ext_len + 1
        cand = torch.where(owned, start, sentinel)
        starts = torch.topk(cand, max_packets, largest=False,
                            sorted=True).values
        valid = starts < sentinel
        starts_c = torch.clamp(torch.where(valid, starts, 0), 0,
                               ext_len - plen)
        return starts_c, valid, owned.sum(dtype=torch.int32)


def _into_slots(fields: dict, rows, slots: int, mesh, axis: str) -> dict:
    """Each rank's decoded fields (rows ``rows`` of the K slots) summed into
    the K slots over ``axis``.  The rank that owns a packet fills its slot
    and every other rank leaves it zero, so the sum is exact bit for bit;
    the fields travel as their bytes, in int32 words, in one all_reduce."""
    words, layout = [], []
    for name, x in fields.items():
        b = x.reshape(x.shape[0], math.prod(x.shape[1:])).contiguous()
        b = b.view(torch.uint8)
        nbytes = b.shape[1]
        b = torch.nn.functional.pad(b, (0, -nbytes % 4)).view(torch.int32)
        words.append(b)
        layout.append((name, x.dtype, tuple(x.shape[1:]), nbytes,
                       b.shape[1]))
    buf = torch.zeros(slots, sum(b.shape[1] for b in words),
                      dtype=torch.int32, device=rows.device)
    buf[rows] = torch.cat(words, dim=1)
    all_reduce(buf, mesh, axis, "results")
    out, col = {}, 0
    for name, dtype, shape, nbytes, width in layout:
        b = buf[:, col:col + width].contiguous().view(torch.uint8)
        out[name] = b[:, :nbytes].contiguous().view(dtype).reshape(
            (slots,) + shape)
        col += width
    return out


def _demod_owned(ext: _Ext, starts_c, valid, plen: int, params: LoraParams,
                 wide: bool, mesh, axis: str, finish) -> dict:
    """Extract the packets this rank owns (every one on one device; with a
    mesh, the valid ones whose start lies in its block), dechirp and
    demodulate them, and decode them with ``finish(DemodResult) -> {field:
    (k, ...) tensor}``.  Returns the fields in the K slots."""
    with span("lora.rx.extract"):
        if mesh is None:
            rows, pos = None, starts_c
        else:
            mine = (valid & (starts_c >= ext.lo)
                    & (starts_c < ext.lo + ext.owned))
            rows = torch.nonzero(mine).flatten()
            pos = starts_c[rows] - ext.lo
        dr, di = extract_dechirp(ext.r, ext.i, pos, plen, params)
    fields = finish((demodulate_wide if wide else demodulate_tones)(
        dr, di, params))
    if mesh is None:
        return fields
    with span("lora.rx.outputs"):
        return _into_slots(fields, rows, starts_c.shape[0], mesh, axis)


def _receive(iq_r, iq_i, params: LoraParams, plen: int, state, mesh,
             axis: str, stride: int, power_gate_db: float, max_packets: int,
             wide: bool, what: str, finish, pack):
    """What both receivers share: check the chunk, scan [tail | chunk]
    (from a zero tail when ``state`` is None), pick the owned starts,
    extract each packet (``plen`` samples), demodulate and decode it
    (``finish(DemodResult) -> {field: (K, ...) tensor}``), and make the
    outputs, ``pack(valid, fields, global starts, owned-candidate count)``.
    Returns (outputs, new state)."""
    if iq_r.ndim != 1:
        raise InvalidArgumentError(
            f"the streaming receivers take one stream, float32 (L,) planes; "
            f"got shape {tuple(iq_r.shape)}")
    if mesh is None and isinstance(iq_r, DTensor):
        raise InvalidArgumentError(
            "a DTensor chunk is received with its mesh: pass mesh=")
    chunk_len = iq_r.shape[-1]
    if chunk_len % stride:
        raise ValueError(f"chunk length {chunk_len} not a multiple of "
                         f"stride {stride}")
    if plen % stride:
        raise ValueError(f"{what} {plen} not a multiple of stride {stride}")
    if mesh is not None:
        shards = axis_size(mesh, axis)
        if chunk_len % (stride * shards):
            raise ValueError(f"chunk length {chunk_len} not a multiple of "
                             f"stride*shards ({stride}*{shards})")

    # extended stream: [prev tail | chunk]; ext position p <-> global
    # sample g = p + offset - plen
    with span("lora.rx.extend"):
        if state is None:
            state = _zero_state(plen, iq_r.device)
        ext, tail_r, tail_i = _extend(iq_r, iq_i, state, plen, mesh, axis)
    starts_c, valid, n_candidates = _owned_starts(
        ext, chunk_len, plen, params, mesh, axis, stride, power_gate_db,
        max_packets, dedupe_tol=max(2, params.osr) if wide else 2,
        max_mis=_wide_max_mis(params, stride) if wide else None)
    fields = _demod_owned(ext, starts_c, valid, plen, params, wide, mesh,
                          axis, finish)
    with span("lora.rx.outputs"):
        out = pack(valid, fields, starts_c + state.offset - plen,
                   n_candidates)
        return out, StreamRxState(tail_r=tail_r, tail_i=tail_i,
                                  offset=state.offset + chunk_len)


def _masked(valid, x):
    """``x`` where the entry holds a real packet, else zero."""
    mask = valid.reshape(valid.shape + (1,) * (x.ndim - 1))
    return torch.where(mask, x, torch.zeros_like(x))


def _demod_fields(res) -> dict:
    return {"sync_word": res.sync_word, "cfo": res.cfo,
            "time_offset": res.time_offset}


@spanned("lora.receive_stream")
def receive_stream(iq_r, iq_i, params: LoraParams, *,
                   payload_symbols: int, max_packets: int,
                   state: StreamRxState | None = None,
                   mesh=None, axis: str = "sp",
                   stride: int | None = None,
                   power_gate_db: float = 5.0,
                   wide: bool | None = None,
                   ) -> tuple[RecoveredPackets, StreamRxState]:
    """Recover every whole packet that completes inside this chunk.

    Args:
      iq_r/iq_i: float32 (L,) tensors, a chunk of the continuous stream; L
        must be a multiple of ``stride`` (and of stride * the ranks of
        ``axis`` with a mesh).  The chunk's device decides the path: a CUDA
        chunk runs the kernels, a CPU chunk the plain versions.
      payload_symbols: data symbols per packet.
      max_packets: recovery capacity per chunk.  If more packets complete
        in a chunk, the earliest ``max_packets`` win.
      state: carried state from the previous chunk (None = stream start).
      mesh/axis: shard the chunk over this axis of a ``DeviceMesh``: the
        planes are DTensors sharded on their time axis over ``axis``
        (``parallel/distributed.py::stream_sharding``), every rank of the
        mesh calls with its own, and every rank returns the one-device
        result (plain tensors, the same on every rank; the state likewise).
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
    plen = packet_samples(params, payload_symbols)

    def finish(res):
        payload, crc_ok = decode(res.symbols)
        return {"payload": payload, "crc_ok": crc_ok, **_demod_fields(res)}

    def pack(valid, f, start, n_candidates):
        return RecoveredPackets(
            payload=_masked(valid, f["payload"]),
            crc_ok=f["crc_ok"] & valid,
            valid=valid,
            start=start,
            sync_word=_masked(valid, f["sync_word"]),
            cfo=_masked(valid, f["cfo"]),
            time_offset=_masked(valid, f["time_offset"]),
            n_candidates=n_candidates,
            n_dropped=torch.clamp(n_candidates - max_packets, min=0),
        )
    return _receive(iq_r, iq_i, params, plen, state, mesh, axis, stride,
                    power_gate_db, max_packets, wide, "packet length",
                    finish, pack)


@spanned("lora.receive_stream_frames")
def receive_stream_frames(iq_r, iq_i, params: LoraParams, *,
                          max_payload_len: int, max_packets: int,
                          crc: bool = True,
                          state: StreamRxState | None = None,
                          mesh=None, axis: str = "sp",
                          stride: int | None = None,
                          power_gate_db: float = 5.0,
                          wide: bool | None = None,
                          ) -> tuple[RecoveredFrames, StreamRxState]:
    """Header-driven variable-length streaming RX.

    ``receive_stream`` needs the caller to fix ``payload_symbols``, so it
    cannot receive a real mixed-length stream.  This entry point decodes
    the explicit header of every detected packet (``models/frame.py``) and
    recovers its advertised length, up to the bound ``max_payload_len``;
    one call serves every length.

    Ownership treats every packet as maximum-length: a start is owned by
    the chunk in which its *maximal* frame window completes, so a frame's
    recovery may land one chunk later than its last symbol, but no frame is
    lost or duplicated whatever the chunking.  Oversize frames (a header
    advertising > max_payload_len) surface with ``hdr_ok == False``.  The
    other arguments, ``mesh``/``axis`` included, are ``receive_stream``'s.

    Returns (RecoveredFrames, new state): state from
    ``stream_frames_init`` (or None at stream start).
    """
    wide = _resolve_wide(params, wide)
    if stride is None:
        stride = _default_stride(params, wide)
    s_max = frame_codec.max_frame_symbols(params, max_payload_len, crc)
    plen = packet_samples(params, s_max)

    def finish(res):
        dec = frame_codec.decode_frame_padded(res.symbols, params,
                                              max_payload_len, crc)
        return {**dec._asdict(), **_demod_fields(res)}

    def pack(valid, f, start, n_candidates):
        return RecoveredFrames(
            payload=_masked(valid, f["payload"]),
            length=_masked(valid, f["length"]),
            hdr_ok=f["hdr_ok"] & valid,
            crc_ok=f["crc_ok"] & valid,
            valid=valid,
            start=start,
            sync_word=_masked(valid, f["sync_word"]),
            cfo=_masked(valid, f["cfo"]),
            time_offset=_masked(valid, f["time_offset"]),
            n_err=_masked(valid, f["n_err"]),
            n_candidates=n_candidates,
            n_dropped=torch.clamp(n_candidates - max_packets, min=0),
        )
    return _receive(iq_r, iq_i, params, plen, state, mesh, axis, stride,
                    power_gate_db, max_packets, wide, "max frame length",
                    finish, pack)

"""SX1272 framed codec: explicit header + whitening + FEC + interleave + Gray.

PyTorch port of ``lora_sdr_lightweight_standalone_library_clean_tpu/models/
frame.py``.  The reference ships every building block of the SX1272 coded
frame (``include/lora_phy/LoRaCodes.hpp``) but never wires them together;
this is the frame the JAX package builds from them:

 * **Header block**: ``ppm_h = sf - 2`` Hamming(8,4) codewords interleaved
   at ``HEADER_RDD = 4`` into ``N_HEADER_SYMBOLS = 8`` symbols of ``sf - 2``
   bits, sent on the reduced grid (``symbol << 2``).  The first five
   codewords carry ``[len >> 4, len & 0xF, flags, chk >> 4, chk & 0xF]``
   with ``flags = (rdd << 1) | crc_en`` and ``chk`` the 5-bit header
   checksum (LoRaCodes.hpp:43-67); the other ``sf - 7`` carry the first
   payload nibbles at CR 4/8.
 * **Payload blocks**: ``sf`` codewords of the profile's coding rate (rdd
   4..1: Hamming 8/4, Hamming 7/4, parity 6/4, parity 5/4) interleaved
   into ``4 + rdd`` symbols of ``sf`` bits.
 * **Whitening**: payload codewords XOR the dual-LFSR SX1272 sequence
   (LoRaCodes.hpp:176-189) at their frame-wide position, masked to the
   codeword width there.
 * **Gray**: TX maps every interleaved value through ``grayToBinary16`` so
   the receiver's ``binaryToGray16`` of the detected bin recovers it.
 * **CRC**: the 2-byte little-endian SX1272 CRC of the payload, appended
   before whitening when ``crc`` is on (LoRaCodes.hpp:92-105).

Plain torch on the tensors' device, batched over leading axes.
``encode_frame``/``decode_frame_padded`` have static (maximum) sizes; the
payload length enters only through masks and gathers, so one call serves
every length up to the bound: that gives the streaming receiver
(``parallel/receiver.py::receive_stream_frames``) its header-driven
variable-length recovery.  ``decode_frame`` is the one host-synchronising
convenience, as in the JAX package.  Symbols are int32 (the JAX package's
uint16 values), bytes uint8, CRCs int32; the header checksum is integer
parity, where the JAX package takes a float matmul mod 2 (the same bits).
Under a ``torch.profiler`` session the encoder is the span
``lora.codec.encode_frame`` and the decoders ``lora.codec.decode_frame``
(``utils/spans.py``).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..ops import codes
from ..utils.config import LoraParams
from ..utils.errors import InvalidArgumentError
from ..utils.spans import spanned
from ..utils.tensors import device_table, int_tensor
from .modem import _crc_position_tables, _xor_reduce_last

__all__ = [
    "FrameHeader", "FrameResult",
    "frame_symbols", "max_frame_symbols",
    "encode_frame", "decode_header", "decode_frame_padded", "decode_frame",
    "header_checksum_batch", "crc_sx1272_at",
]


class FrameHeader(NamedTuple):
    """Decoded explicit header (batched tensors)."""

    length: torch.Tensor    # payload bytes (excl. CRC), int32
    rdd: torch.Tensor       # coding-rate redundancy from the flags nibble
    crc_en: torch.Tensor    # bool, CRC-present flag
    hdr_ok: torch.Tensor    # bool, 5-bit checksum + field validity


class FrameResult(NamedTuple):
    payload: torch.Tensor   # (..., max_len) uint8, zero past ``length``
    length: torch.Tensor    # (...,) int32 payload bytes from the header
    hdr_ok: torch.Tensor    # (...,) bool
    crc_ok: torch.Tensor    # (...,) bool (False when hdr_ok is False;
                            # equal to hdr_ok when the frame carries no CRC)
    n_err: torch.Tensor     # (...,) int32 FEC-corrected/detected codewords


# ---------------------------------------------------------------------------
# Static geometry
# ---------------------------------------------------------------------------

def _check_sf(sf: int) -> None:
    if sf < 7:
        raise InvalidArgumentError(
            f"framed codec needs sf >= 7 (header block holds "
            f"{codes.N_HEADER_CODEWORDS} codewords in sf-2), got sf={sf}")


def _hdr_payload_cap(sf: int) -> int:
    """Payload nibbles riding in the header block: (sf-2) - 5."""
    return (sf - 2) - codes.N_HEADER_CODEWORDS


def _frame_geometry(params: LoraParams, length: int, crc: bool):
    """(payload nibbles, payload blocks, total symbols) for a static length."""
    _check_sf(params.sf)
    nib = 2 * (length + (2 if crc else 0))
    cap = _hdr_payload_cap(params.sf)
    rem = max(0, nib - cap)
    blocks = -(-rem // params.sf)
    symbols = codes.N_HEADER_SYMBOLS + blocks * (4 + params.rdd)
    return nib, blocks, symbols


def frame_symbols(params: LoraParams, length: int, crc: bool = True) -> int:
    """On-air symbol count of a framed packet with ``length`` payload bytes."""
    return _frame_geometry(params, length, crc)[2]


def max_frame_symbols(params: LoraParams, max_length: int,
                      crc: bool = True) -> int:
    """Symbol bound used by the padded decoder / streaming receiver."""
    return frame_symbols(params, max_length, crc)


# ---------------------------------------------------------------------------
# FEC tables per coding rate (encode: 16 entries; decode: 2^(4+rdd))
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _fec_tables(rdd: int):
    """(encode_lut[16], decode_lut, err_lut) int32 host arrays for one rdd."""
    nib = np.arange(16, dtype=np.uint8)
    if rdd == 4:
        enc = codes.encode_hamming84(nib)
        cw = np.arange(256, dtype=np.uint16)
        dec, err, bad = codes.decode_hamming84(cw, return_flags=True)
        err = err | bad
    elif rdd == 3:
        enc = codes.encode_hamming74(nib)
        cw = np.arange(128, dtype=np.uint16)
        dec, err = codes.decode_hamming74(cw, return_flags=True)
    elif rdd == 2:
        enc = codes.encode_parity64(nib)
        cw = np.arange(64, dtype=np.uint8)
        dec, err = codes.check_parity64(cw, return_flags=True)
    elif rdd == 1:
        enc = codes.encode_parity54(nib)
        cw = np.arange(32, dtype=np.uint8)
        dec, err = codes.check_parity54(cw, return_flags=True)
    else:
        raise InvalidArgumentError(f"rdd must be 1..4, got {rdd}")
    return (enc.astype(np.int32), dec.astype(np.int32), err.astype(np.int32))


@functools.lru_cache(maxsize=None)
def _whiten_keys(n_cw: int, cap: int, rdd: int) -> np.ndarray:
    """Frame-positional whitening keys: full 8-bit dual-LFSR bytes masked to
    the codeword width active at each position: the first ``cap``
    header-block ride-along codewords are CR 4/8 (8-bit), later positions
    use the profile's ``4 + rdd``-bit mask (LoRaCodes.hpp:178)."""
    full = codes.whitening_sequence_lfsr(max(n_cw, 1), 0, rdd=4)
    masks = np.where(np.arange(max(n_cw, 1)) < cap, 0xFF,
                     0xFF >> (4 - rdd))
    return (full & masks).astype(np.int32)


def _lookup(table, idx):
    """``table[idx]`` for an int32 index tensor (the JAX package's
    ``jnp.take(table, idx, axis=0)`` on in-range indices)."""
    return table[idx.long()]


# ---------------------------------------------------------------------------
# Header checksum, batched (LoRaCodes.hpp:43-67)
# ---------------------------------------------------------------------------

def _hdr_parity() -> np.ndarray:
    return codes._HDR_PARITY.astype(np.int32)


def header_checksum_batch(h0, h1):
    """5-bit explicit-header checksum over batched (h0, h1) byte values:
    the parity matrix's rows as integer XOR sums (int32 out)."""
    h0 = int_tensor(h0, torch.int32)
    h1 = (h1.to(torch.int32) if isinstance(h1, torch.Tensor) else
          torch.as_tensor(np.asarray(h1).astype(np.int64)).to(h0.device,
                                                               torch.int32))
    dev = h0.device
    shifts0 = torch.arange(7, -1, -1, dtype=torch.int32, device=dev)
    shifts1 = torch.arange(3, -1, -1, dtype=torch.int32, device=dev)
    bits = torch.cat([(h0[..., None] >> shifts0) & 1,
                      (h1[..., None] >> shifts1) & 1], dim=-1)   # (..., 12)
    par = device_table(_hdr_parity, device=dev)                  # (5, 12)
    out = (bits[..., None, :] * par).sum(dim=-1, dtype=torch.int32) & 1
    weights = torch.tensor([16, 8, 4, 2, 1], dtype=torch.int32, device=dev)
    return (out * weights).sum(dim=-1, dtype=torch.int32)


# ---------------------------------------------------------------------------
# Dynamic-length CRC: crc over data[..., :length]
# ---------------------------------------------------------------------------

def _crc_position_flat(n: int) -> np.ndarray:
    return _crc_position_tables(n).reshape(-1).astype(np.int32)


def _v_seq() -> np.ndarray:
    return codes._V_SEQ.astype(np.int32)


def crc_sx1272_at(data, length):
    """SX1272 CRC-16 over the first ``length`` bytes of the last axis.

    ``length`` is batched (an int tensor, or host data placed on the data's
    device): the variable-length counterpart of ``models.modem.
    crc_sx1272`` for header-driven frames.  GF(2)-linearity replaces the
    byte loop with a masked per-position table gather and an XOR fold
    (byte i of an L-byte message contributes step^{L-1-i}(byte)); the two
    length-dependent LFSR mask bytes (LoRaCodes.hpp:101-103) come from a
    precomputed sequence gather.  Returns int32 values < 2^16.
    """
    d = int_tensor(data, torch.int32)
    dev = d.device
    length = (length.to(device=dev, dtype=torch.int32)
              if isinstance(length, torch.Tensor) else
              torch.as_tensor(np.asarray(length).astype(np.int64),
                              device=dev).to(torch.int32))
    n = d.shape[-1]
    flat = device_table(_crc_position_flat, max(n, 1), device=dev)
    i = torch.arange(n, dtype=torch.int32, device=dev)
    k = torch.clamp(length[..., None] - 1 - i, 0, max(n - 1, 0))
    contrib = _lookup(flat, k * 256 + d)
    contrib = torch.where(i < length[..., None], contrib,
                          torch.zeros_like(contrib))
    res = _xor_reduce_last(contrib)
    vseq = device_table(_v_seq, device=dev)
    top = vseq.shape[0] - 1
    m0 = _lookup(vseq, torch.clamp(length, 0, top))
    m1 = _lookup(vseq, torch.clamp(length + 1, 0, top))
    return (res ^ m0 ^ (m1 << 8)) & 0xFFFF


# ---------------------------------------------------------------------------
# Encode
# ---------------------------------------------------------------------------

@spanned("lora.codec.encode_frame")
def encode_frame(payload, params: LoraParams, crc: bool = True):
    """Payload bytes -> framed on-air symbols (batched), int32.

    ``payload`` has a fixed last-axis length, so the symbol count is
    ``frame_symbols``.  Feed the result to ``modulate`` (or
    ``modulate_dechirped``): the sync prelude is added there
    (LoRaMod.cpp:20-32).  Host data goes to the card unless it is a CPU
    tensor (``utils/tensors.py::int_tensor``).
    """
    p = int_tensor(payload, torch.int32)
    dev = p.device
    length = p.shape[-1]
    lead = p.shape[:-1]
    sf, rdd = params.sf, params.rdd
    nib_total, blocks, _ = _frame_geometry(params, length, crc)
    cap = _hdr_payload_cap(sf)
    n_cw = cap + blocks * sf                      # payload codeword positions

    if crc:
        c = crc_sx1272_at(p, torch.full(lead, length, dtype=torch.int32,
                                        device=dev))
        data = torch.cat([p, (c & 0xFF)[..., None], (c >> 8)[..., None]],
                         dim=-1)
    else:
        data = p
    nib = torch.stack([(data >> 4) & 0xF, data & 0xF], dim=-1)
    nib = nib.reshape(lead + (nib_total,))
    pad = n_cw - nib_total
    if pad > 0:
        nib = torch.nn.functional.pad(nib, (0, pad))

    # FEC encode: header-block ride-along at CR4/8, blocks at the profile CR
    enc84 = device_table(_fec_tables, 4, device=dev)[0]
    enc_p = device_table(_fec_tables, rdd, device=dev)[0]
    cw_head = _lookup(enc84, nib[..., :cap])
    cw_body = _lookup(enc_p, nib[..., cap:])

    # whitening at frame codeword positions (header nibbles stay clear)
    keys = device_table(_whiten_keys, n_cw, cap, rdd, device=dev)
    cw_head = cw_head ^ keys[:cap]
    cw_body = cw_body ^ keys[cap:]

    # explicit header: [len, (rdd << 1) | crc] + 5-bit checksum
    h0 = torch.full(lead, length & 0xFF, dtype=torch.int32, device=dev)
    h1 = torch.full(lead, ((rdd << 1) | (1 if crc else 0)) & 0xF,
                    dtype=torch.int32, device=dev)
    chk = header_checksum_batch(h0, h1)
    hdr_nib = torch.stack([h0 >> 4, h0 & 0xF, h1, chk >> 4, chk & 0xF],
                          dim=-1)
    hdr_cw = _lookup(enc84, hdr_nib)

    # interleave + gray; the header block rides the reduced (<< 2) grid
    blk0 = torch.cat([hdr_cw, cw_head], dim=-1)            # (..., sf-2)
    sym0 = codes.gray_to_binary16(codes.diagonal_interleave(blk0, sf - 2, 4))
    air = (sym0 << 2) & ((1 << sf) - 1)
    if blocks:
        symb = codes.gray_to_binary16(
            codes.diagonal_interleave(cw_body, sf, rdd))
        air = torch.cat([air, symb], dim=-1)
    return air


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def _decode_header_block(s, params: LoraParams):
    """First 8 symbols (int32 tensor) -> (FrameHeader, ride-along payload
    nibbles, errors)."""
    sf = params.sf
    dev = s.device
    cap = _hdr_payload_cap(sf)
    # reduced-grid snap with rounding: a +-1-bin detection error on the
    # << 2 air symbol still lands on the right header value
    g = codes.binary_to_gray16(((s + 2) >> 2) & ((1 << (sf - 2)) - 1))
    cw = codes.diagonal_deinterleave(g[..., :codes.N_HEADER_SYMBOLS],
                                     sf - 2, 4)
    _, dec84, err84 = device_table(_fec_tables, 4, device=dev)
    hdr_nib = _lookup(dec84, cw[..., :5])
    hdr_err = _lookup(err84, cw[..., :5])
    keys = device_table(_whiten_keys, max(cap, 1), cap, params.rdd,
                        device=dev)
    ride_cw = cw[..., 5:] ^ keys[:cap]
    ride_nib = _lookup(dec84, ride_cw)
    ride_err = _lookup(err84, ride_cw)

    h0 = (hdr_nib[..., 0] << 4) | hdr_nib[..., 1]
    h1 = hdr_nib[..., 2]
    chk = ((hdr_nib[..., 3] & 1) << 4) | hdr_nib[..., 4]
    ok = (header_checksum_batch(h0, h1) == chk) & (hdr_nib[..., 3] <= 1)
    rdd_f = (h1 >> 1) & 0x7
    crc_en = (h1 & 1).to(torch.bool)
    ok = ok & (rdd_f >= 1) & (rdd_f <= 4) & (h0 >= 1)
    hdr = FrameHeader(length=h0, rdd=rdd_f, crc_en=crc_en, hdr_ok=ok)
    n_err = (hdr_err.sum(dim=-1, dtype=torch.int32)
             + ride_err.sum(dim=-1, dtype=torch.int32))
    return hdr, ride_nib, n_err


def decode_header(symbols, params: LoraParams) -> FrameHeader:
    """Parse the explicit header from the first 8 demodulated symbols."""
    return _decode_header_block(int_tensor(symbols, torch.int32), params)[0]


@spanned("lora.codec.decode_frame")
def decode_frame_padded(symbols, params: LoraParams,
                        max_payload_len: int,
                        crc: bool = True) -> FrameResult:
    """Framed decode with static bounds: one call for every payload length
    up to ``max_payload_len`` (the streaming RX entry point).

    ``symbols`` must provide at least ``max_frame_symbols`` entries; entries
    past the actual frame are ignored.  The profile's coding rate is the
    static truth: a header advertising a different rate fails ``hdr_ok``.
    """
    sf, rdd = params.sf, params.rdd
    _, max_blocks, s_need = _frame_geometry(params, max_payload_len, crc)
    s = int_tensor(symbols, torch.int32)
    dev = s.device
    if s.shape[-1] < s_need:
        raise InvalidArgumentError(
            f"need {s_need} symbols for max_payload_len={max_payload_len}, "
            f"got {s.shape[-1]}")
    cap = _hdr_payload_cap(sf)
    n_cw = cap + max_blocks * sf

    hdr, ride_nib, n_err0 = _decode_header_block(s, params)

    if max_blocks:
        body = s[..., codes.N_HEADER_SYMBOLS:
                 codes.N_HEADER_SYMBOLS + max_blocks * (4 + rdd)]
        body = codes.binary_to_gray16(body & ((1 << sf) - 1))
        keys = device_table(_whiten_keys, n_cw, cap, rdd, device=dev)
        cw = codes.diagonal_deinterleave(body, sf, rdd) ^ keys[cap:]
        _, dec_p, err_p = device_table(_fec_tables, rdd, device=dev)
        nib = torch.cat([ride_nib, _lookup(dec_p, cw)], dim=-1)
        errs = _lookup(err_p, cw)
    else:
        nib = ride_nib
        errs = torch.zeros(nib.shape[:-1] + (0,), dtype=torch.int32,
                           device=dev)

    n_bytes = n_cw // 2
    by = (nib[..., 0:2 * n_bytes:2] << 4) | nib[..., 1:2 * n_bytes:2]

    length = torch.clamp(hdr.length, 0, max_payload_len)
    # FEC-error observability only over codewords the frame actually uses
    used_nib = 2 * (length + torch.where(hdr.crc_en, 2, 0))
    used_body = torch.clamp(used_nib - cap, 0, max_blocks * sf)
    pos = torch.arange(errs.shape[-1], dtype=torch.int32, device=dev)
    n_err = n_err0 + torch.where(pos < used_body[..., None], errs,
                                 torch.zeros_like(errs)).sum(
                                     dim=-1, dtype=torch.int32)

    if crc:
        calc = crc_sx1272_at(by, length)
        li = torch.clamp(length, 0, n_bytes - 1)[..., None].long()
        c0 = torch.gather(by, -1, li)[..., 0]
        c1 = torch.gather(by, -1, torch.clamp(li + 1, 0, n_bytes - 1))[..., 0]
        room = (length + 2) * 2 <= n_cw
        crc_ok = hdr.hdr_ok & hdr.crc_en & room & ((c0 | (c1 << 8)) == calc)
    else:
        crc_ok = hdr.hdr_ok & ~hdr.crc_en

    ok_len = hdr.hdr_ok & (hdr.length <= max_payload_len) & (hdr.rdd == rdd)
    idx = torch.arange(max_payload_len, dtype=torch.int32, device=dev)
    src = torch.clamp(idx, 0, n_bytes - 1).long()
    payload = torch.where(idx < length[..., None], by[..., src],
                          torch.zeros((), dtype=by.dtype, device=dev))
    return FrameResult(
        payload=payload.to(torch.uint8),
        length=length,
        hdr_ok=ok_len,
        crc_ok=crc_ok & ok_len,
        n_err=n_err,
    )


@spanned("lora.codec.decode_frame")
def decode_frame(symbols, params: LoraParams) -> FrameResult:
    """Host convenience decode of ONE frame: exact-size payload.

    Parses the header, sizes the decode to the advertised length, and trims
    the result.  It reads the header on the host (a synchronisation): use
    ``decode_frame_padded`` in batched and streaming paths.
    """
    s = int_tensor(symbols, torch.int32)
    hdr = decode_header(s[..., :codes.N_HEADER_SYMBOLS], params)
    if not bool(hdr.hdr_ok):
        return FrameResult(
            torch.zeros((0,), dtype=torch.uint8, device=s.device),
            hdr.length, hdr.hdr_ok,
            torch.zeros((), dtype=torch.bool, device=s.device),
            torch.zeros((), dtype=torch.int32, device=s.device))
    length = int(hdr.length)
    crc = bool(hdr.crc_en)
    need = frame_symbols(params, length, crc)
    if s.shape[-1] < need:
        raise InvalidArgumentError(
            f"header advertises {length} bytes -> {need} symbols, "
            f"got {s.shape[-1]}")
    res = decode_frame_padded(s[..., :need], params, length, crc)
    return FrameResult(res.payload[..., :length], res.length, res.hdr_ok,
                       res.crc_ok, res.n_err)

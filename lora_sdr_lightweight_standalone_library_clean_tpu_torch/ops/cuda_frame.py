"""The framed decoder on the card: one hand-written CUDA kernel.

``models/frame.py::decode_frame_padded`` decodes SX1272 frames of every
length up to a bound from rows of demodulated symbols.  On a CUDA tensor it
calls ``decode_frame`` here, which launches ``csrc/decode_frame.cu`` once
for every row: the header block (snap to the reduced grid, Gray, diagonal
deinterleave at ``sf - 2``, Hamming 8/4), the 5-bit header checksum and
the field checks, the ride-along nibbles, the body blocks (Gray,
deinterleave at ``sf``, dewhitening at frame positions, the FEC table of
the profile's rate), the bytes, ``n_err`` over the codewords the frame
uses, the SX1272 CRC over the header's length with its two LFSR mask
bytes, and the masked payload.  A CPU tensor runs the plain torch chain,
``models/frame.py::decode_frame_padded_ref``, which stays the yardstick:
the kernel's five outputs equal it bit for bit on every row.

The launch path runs in the span ``lora.kernel.decode_frame`` (inside
``lora.codec.decode_frame``), and each launch adds one to
``COUNTS["launch.decode_frame"]`` (``utils/spans.py``).  It takes int32
symbols on the card, (..., S) with S at least ``max_frame_symbols``, and
flattens the leading axes; a non-contiguous input is made contiguous.  The
tables reach the kernel as cached ``device_table``s (the Hamming 8/4 and
profile FEC tables, the whitening keys, the CRC position table and the
masking LFSR sequence), so after the first call of a shape a call copies
nothing from the host and waits for nothing.  Anything else raises
``InvalidArgumentError``.

Kernel note.  Replaces no TPU kernel: the JAX package's framed codec is
jnp code that XLA fuses on the TPU.  Eager PyTorch runs it as about a
hundred small kernels, and its diagonal deinterleave copied index grids
from the host on every call, each copy a wait for the card.  The kernel
is bound by bytes: the int32 symbol rows read once and the outputs written
once (17.6 MB and 3.2 MB at 12,660 rows of 348 symbols).  It gives each
row one warp and keeps every intermediate (symbols after Gray, nibbles) in
shared memory, so nothing but the rows and the outputs crosses device
memory; its integer arithmetic is the plain path's, step for step.
"""
from __future__ import annotations

import operator
from typing import NamedTuple

import torch

from ..utils import cuda_build
from ..utils.config import LoraParams
from ..utils.errors import InvalidArgumentError
from ..utils.spans import count, span
from ..utils.tensors import device_table

__all__ = ["decode_frame", "geometry", "kernel_tables", "Geometry",
           "Tables", "HDR_MASKS", "MAX_LEN"]

# The rows of the header checksum's parity matrix (ops/codes.py::
# _HDR_PARITY) as 12-bit masks of (h0 << 4) | h1, column j at bit 11 - j:
# checksum bit 4 - r is the parity of the masked bits (the kernel's
# header_checksum holds the same five numbers).
HDR_MASKS = (0xF00, 0x8E1, 0x49A, 0x257, 0x12F)
# The largest max_payload_len whose rows fit the kernel's shared memory at
# every profile (one header byte carries at most 255).
MAX_LEN = 4096


class Geometry(NamedTuple):
    """The padded decoder's static sizes for one (profile, bound, crc)."""

    cap: int            # ride-along codewords in the header block, sf - 7
    body_cw: int        # body codewords: blocks x sf
    n_cw: int           # payload codeword positions, cap + body_cw
    n_bytes: int        # decoded bytes, n_cw // 2
    s_need: int         # symbols read a row: 8 + blocks x (4 + rdd)


class Tables(NamedTuple):
    """The kernel's tables, int32 tensors on one device."""

    dec84: torch.Tensor     # (256,) Hamming 8/4 nibble
    err84: torch.Tensor     # (256,) Hamming 8/4 error or uncorrectable
    decp: torch.Tensor      # (2^(4+rdd),) the profile rate's nibble
    errp: torch.Tensor      # (2^(4+rdd),) its error flag
    keys: torch.Tensor      # (n_cw,) whitening key at each frame position
    crc: torch.Tensor       # (n_bytes * 256,) step^k(b) at k * 256 + b
    vseq: torch.Tensor      # (4096,) the CRC's masking LFSR sequence


def geometry(params: LoraParams, max_payload_len: int,
             crc: bool) -> Geometry:
    """The static sizes ``decode_frame_padded`` works with (raises
    ``InvalidArgumentError`` below sf 7)."""
    from ..models import frame
    _, blocks, s_need = frame._frame_geometry(params, max_payload_len, crc)
    cap = frame._hdr_payload_cap(params.sf)
    body_cw = blocks * params.sf
    return Geometry(cap, body_cw, cap + body_cw, (cap + body_cw) // 2,
                    s_need)


def kernel_tables(params: LoraParams, max_payload_len: int, crc: bool,
                  device) -> Tables:
    """The tables the kernel reads, cached on ``device`` (the plain path's
    own table functions)."""
    from ..models import frame
    g = geometry(params, max_payload_len, crc)
    _, dec84, err84 = device_table(frame._fec_tables, 4, device=device)
    _, decp, errp = device_table(frame._fec_tables, params.rdd,
                                 device=device)
    keys = device_table(frame._whiten_keys, g.n_cw, g.cap, params.rdd,
                        device=device)
    crc_tab = device_table(frame._crc_position_flat, max(g.n_bytes, 1),
                           device=device)
    vseq = device_table(frame._v_seq, device=device)
    return Tables(dec84, err84, decp, errp, keys, crc_tab, vseq)


def decode_frame(symbols, params: LoraParams, max_payload_len: int,
                 crc: bool = True):
    """``decode_frame_padded`` on the card in one launch.

    ``symbols``: int32 CUDA tensor (..., S), S >= ``max_frame_symbols(
    params, max_payload_len, crc)``.  Returns (payload uint8 (...,
    max_payload_len), length int32 (...), hdr_ok bool, crc_ok bool, n_err
    int32), the fields of ``FrameResult``.
    """
    with span("lora.kernel.decode_frame"):
        if not isinstance(symbols, torch.Tensor) or not symbols.is_cuda:
            raise InvalidArgumentError(
                "decode_frame: symbols must be a CUDA tensor")
        if symbols.dtype != torch.int32 or symbols.ndim < 1:
            raise InvalidArgumentError(
                f"decode_frame: symbols must be int32 (..., S), got "
                f"{symbols.dtype} of shape {tuple(symbols.shape)}")
        if (isinstance(max_payload_len, bool)
                or not 0 <= operator.index(max_payload_len) <= MAX_LEN):
            raise InvalidArgumentError(
                f"decode_frame takes a max_payload_len in [0, {MAX_LEN}], "
                f"got {max_payload_len!r}")
        max_payload_len = operator.index(max_payload_len)
        g = geometry(params, max_payload_len, crc)
        lead, width = symbols.shape[:-1], symbols.shape[-1]
        if width < g.s_need:
            raise InvalidArgumentError(
                f"need {g.s_need} symbols for max_payload_len="
                f"{max_payload_len}, got {width}")
        rows = symbols.reshape(-1, width).contiguous()
        k = rows.shape[0]
        dev = rows.device
        payload = torch.empty((k, max_payload_len), dtype=torch.uint8,
                              device=dev)
        length = torch.empty(k, dtype=torch.int32, device=dev)
        hdr_ok = torch.empty(k, dtype=torch.bool, device=dev)
        crc_ok = torch.empty(k, dtype=torch.bool, device=dev)
        n_err = torch.empty(k, dtype=torch.int32, device=dev)
        if k:
            t = kernel_tables(params, max_payload_len, crc, dev)
            lib = cuda_build.load()
            with torch.cuda.device(dev):
                err = lib.lora_decode_frame(
                    rows.data_ptr(), k, width, params.sf, params.rdd,
                    max_payload_len, int(bool(crc)), g.body_cw,
                    t.dec84.data_ptr(), t.err84.data_ptr(),
                    t.decp.data_ptr(), t.errp.data_ptr(),
                    t.keys.data_ptr(), t.crc.data_ptr(), t.vseq.data_ptr(),
                    t.vseq.shape[0], payload.data_ptr(), length.data_ptr(),
                    hdr_ok.data_ptr(), crc_ok.data_ptr(), n_err.data_ptr(),
                    torch.cuda.current_stream(dev).cuda_stream)
            if err:
                raise RuntimeError(
                    f"lora_decode_frame launch failed: cudaError_t {err}")
            count("launch.decode_frame")
        return (payload.reshape(lead + (max_payload_len,)),
                length.reshape(lead), hdr_ok.reshape(lead),
                crc_ok.reshape(lead), n_err.reshape(lead))

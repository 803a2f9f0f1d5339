"""LoRa coding toolbox: checksums, whitening, Gray mapping, FEC, interleaving.

PyTorch port of ``lora_sdr_lightweight_standalone_library_clean_tpu/ops/
codes.py`` (reference ``include/lora_phy/LoRaCodes.hpp``).  The port keeps
its own copy of the JAX package's host tables, built in numpy exactly as
there: LoRa has no weights, and these tables and constants are the state
carried across (``tests/test_torch_codes.py`` holds every one of them equal,
bit for bit, to the JAX module's arrays).

The host functions take and return numpy arrays, as in the JAX package.
Gray mapping and the diagonal (de)interleaver also take tensors (the framed
codec's device path, ``models/frame.py``): the JAX package passes
``xp=jnp`` for that; here a tensor input runs torch ops on its own device.
Torch's uint16 supports few operations, so the tensor forms compute in
int32 with explicit masks: ``& 0xFFFF`` where the JAX package converts to
uint16, ``& 0xFF`` where it truncates to uint8.

Semantics parity (reference citations):
 - ``checksum8``                -> LoRaCodes.hpp:32-41
 - ``header_checksum``          -> LoRaCodes.hpp:43-67
 - ``crc16sx`` / ``sx1272_data_checksum`` -> LoRaCodes.hpp:69-105
 - ``whiten_sx1232``            -> LoRaCodes.hpp:111-137 (AN1200.18 x^9+x^5+1)
 - ``whiten_sx1272``            -> LoRaCodes.hpp:147-167 (510-bit sequence)
 - ``whiten_sx1272_lfsr``       -> LoRaCodes.hpp:176-189 (dual 8-bit LFSR 0x1D)
 - ``binary_to_gray16`` / ``gray_to_binary16`` -> LoRaCodes.hpp:201-222
 - Hamming(8,4)/(7,4), parity 5/4 + 6/4 -> LoRaCodes.hpp:229-371
 - ``diagonal_interleave`` / ``diagonal_deinterleave`` -> LoRaCodes.hpp:376-412

All sequence/seed constants are protocol data reverse-engineered from SX1272
hardware traffic; they are reproduced as data, the algorithms are re-derived.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.tensors import device_table

__all__ = [
    "HEADER_RDD",
    "N_HEADER_SYMBOLS",
    "N_HEADER_CODEWORDS",
    "checksum8",
    "header_checksum",
    "crc16sx",
    "xsum8",
    "sx1272_data_checksum",
    "crc16_table",
    "crc_mask_pair",
    "whiten_sx1232",
    "whiten_sx1272",
    "whiten_sx1272_lfsr",
    "whitening_sequence_lfsr",
    "binary_to_gray16",
    "gray_to_binary16",
    "encode_hamming84",
    "decode_hamming84",
    "encode_hamming74",
    "decode_hamming74",
    "encode_parity54",
    "check_parity54",
    "encode_parity64",
    "check_parity64",
    "diagonal_interleave",
    "diagonal_deinterleave",
    "HAMMING84_ENCODE_LUT",
    "HAMMING84_DECODE_LUT",
    "HAMMING84_ERROR_LUT",
    "HAMMING84_BAD_LUT",
    "HAMMING74_ENCODE_LUT",
    "HAMMING74_DECODE_LUT",
    "HAMMING74_ERROR_LUT",
]

HEADER_RDD = 4
N_HEADER_SYMBOLS = HEADER_RDD + 4
N_HEADER_CODEWORDS = 5


# ---------------------------------------------------------------------------
# Simple checksums
# ---------------------------------------------------------------------------

def checksum8(data) -> int:
    """Rotate-and-add 8-bit checksum (LoRaCodes.hpp:32-41)."""
    acc = 0
    for b in np.asarray(data, dtype=np.uint8).ravel():
        acc = ((acc >> 1) | ((acc & 0x1) << 7)) & 0xFF
        acc = (acc + int(b)) & 0xFF
    return acc


# 5-bit parity matrix of the explicit-header checksum (LoRaCodes.hpp:43-67).
# Rows: output bits 4..0; columns: the 12 input bits
# [a3 a2 a1 a0 b3 b2 b1 b0 c3 c2 c1 c0] where a = h0>>4, b = h0&0xf, c = h1&0xf.
_HDR_PARITY = np.array(
    [
        # a3 a2 a1 a0 b3 b2 b1 b0 c3 c2 c1 c0
        [1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0],  # bit4 = a0^a1^a2^a3
        [1, 0, 0, 0, 1, 1, 1, 0, 0, 0, 0, 1],  # bit3 = a3^b1^b2^b3^c0
        [0, 1, 0, 0, 1, 0, 0, 1, 1, 0, 1, 0],  # bit2 = a2^b0^b3^c1^c3
        [0, 0, 1, 0, 0, 1, 0, 1, 0, 1, 1, 1],  # bit1 = a1^b0^b2^c0^c1^c2
        [0, 0, 0, 1, 0, 0, 1, 0, 1, 1, 1, 1],  # bit0 = a0^b1^c0^c1^c2^c3
    ],
    dtype=np.uint8,
)


def header_checksum(h) -> int:
    """5-bit checksum over a 2-byte explicit header (LoRaCodes.hpp:43-67)."""
    h = np.asarray(h, dtype=np.uint8)
    h0, h1 = int(h[0]), int(h[1])
    bits = np.array(
        [
            (h0 >> 7) & 1, (h0 >> 6) & 1, (h0 >> 5) & 1, (h0 >> 4) & 1,
            (h0 >> 3) & 1, (h0 >> 2) & 1, (h0 >> 1) & 1, (h0 >> 0) & 1,
            (h1 >> 3) & 1, (h1 >> 2) & 1, (h1 >> 1) & 1, (h1 >> 0) & 1,
        ],
        dtype=np.uint8,
    )
    out_bits = (_HDR_PARITY @ bits) & 1
    res = 0
    for i, b in enumerate(out_bits):
        res |= int(b) << (4 - i)
    return res


# ---------------------------------------------------------------------------
# SX1272 CRC-16 (masked CCITT)  --  LoRaCodes.hpp:69-105
# ---------------------------------------------------------------------------

def crc16sx(crc: int, poly: int = 0x1021) -> int:
    """Eight left-shift steps of the CCITT CRC (LoRaCodes.hpp:69-79)."""
    crc &= 0xFFFF
    for _ in range(8):
        if crc & 0x8000:
            crc = ((crc << 1) ^ poly) & 0xFFFF
        else:
            crc = (crc << 1) & 0xFFFF
    return crc


def xsum8(t: int) -> int:
    """Parity of a byte (LoRaCodes.hpp:81-86)."""
    t &= 0xFF
    t ^= t >> 4
    t ^= t >> 2
    t ^= t >> 1
    return t & 1


def _build_crc16_table(poly: int = 0x1021) -> np.ndarray:
    """256-entry table such that crc16sx(res) == ((res<<8)^T[res>>8]) & 0xffff."""
    tab = np.zeros(256, dtype=np.uint16)
    for b in range(256):
        tab[b] = crc16sx(b << 8, poly) & 0xFFFF
    return tab


_CRC16_TABLE = _build_crc16_table()


def crc16_table() -> np.ndarray:
    """The 256-entry CCITT 0x1021 step table."""
    return _CRC16_TABLE.copy()


def _v_lfsr_sequence(n: int) -> np.ndarray:
    """Sequence of the 8-bit masking LFSR v (poly mask 0xB8, seed 0xFF).

    v[0] = 0xFF and v[k+1] = xsum8(v[k] & 0xB8) | (v[k] << 1), mirroring the
    per-byte advance in sx1272DataChecksum (LoRaCodes.hpp:96-103).
    """
    seq = np.zeros(n, dtype=np.uint8)
    v = 0xFF
    for i in range(n):
        seq[i] = v
        v = (xsum8(v & 0xB8) | ((v << 1) & 0xFF)) & 0xFF
    return seq


_V_SEQ = _v_lfsr_sequence(4096)


def crc_mask_pair(length: int) -> tuple[int, int]:
    """The two masking LFSR bytes XOR-ed into the CRC for a given payload length.

    sx1272DataChecksum advances v once per data byte, then applies v and the
    next v to the low/high result byte (LoRaCodes.hpp:101-103).
    """
    if length + 1 < len(_V_SEQ):
        return int(_V_SEQ[length]), int(_V_SEQ[length + 1])
    seq = _v_lfsr_sequence(length + 2)
    return int(seq[length]), int(seq[length + 1])


def sx1272_data_checksum(data) -> int:
    """Modified CCITT CRC-16 with LFSR output masking (LoRaCodes.hpp:92-105)."""
    data = np.asarray(data, dtype=np.uint8).ravel()
    res = 0
    for b in data:
        crc = ((res << 8) & 0xFFFF) ^ int(_CRC16_TABLE[res >> 8])
        res = crc ^ int(b)
    m0, m1 = crc_mask_pair(len(data))
    res ^= m0
    res ^= m1 << 8
    return res & 0xFFFF


# ---------------------------------------------------------------------------
# Whitening  --  LoRaCodes.hpp:111-189
# ---------------------------------------------------------------------------

def whiten_sx1232(data) -> np.ndarray:
    """AN1200.18 whitening, x^9+x^5+1 LFSR seeded 0x1FF (LoRaCodes.hpp:111-137).

    Returns a new whitened array; apply twice for the identity.
    """
    data = np.array(data, dtype=np.uint8)
    out = data.copy()
    key = _SX1232_KEY_SEQ[: out.size]
    out ^= key
    return out


def _sx1232_key_sequence(n: int) -> np.ndarray:
    """Per-byte whitening key of the SX1232 LFSR (the key LSB before each byte)."""
    msb, lsb = 0x01, 0xFF
    seq = np.zeros(n, dtype=np.uint8)
    for j in range(n):
        seq[j] = lsb
        for _ in range(8):
            prev_msb = msb
            msb = (lsb & 0x01) ^ ((lsb >> 5) & 0x01)
            lsb = ((lsb >> 1) & 0xFF) | ((prev_msb << 7) & 0x80)
    return seq


_SX1232_KEY_SEQ = _sx1232_key_sequence(4096)


# 510-bit whitening sequence observed on SX1272 hardware, stored as 8 uint64
# words (LoRaCodes.hpp:151-154).  Protocol data, not code.
_WHITEN_SEQ_WORDS = np.array(
    [
        0x0102291EA751AAFF, 0xD24B050A8D643A17, 0x5B279B671120B8F4,
        0x032B37B9F6FB55A2, 0x994E0F87E95E2D16, 0x7CBCFC7631984C26,
        0x281C8E4F0DAEF7F9, 0x1741886EB7733B15,
    ],
    dtype=np.uint64,
)
_WHITEN_LEN = 510
_WHITEN_BITS = np.array(
    [(int(_WHITEN_SEQ_WORDS[t >> 6]) >> (t & 0x3F)) & 1 for t in range(512)],
    dtype=np.uint8,
)
_OFS0 = np.array([6, 4, 2, 0, -112, -114, -302, -34], dtype=np.int64)
_OFS1 = np.array([6, 4, 2, 0, -360], dtype=np.int64)


def whiten_sx1272(data, bit_ofs: int = 0, rdd: int = 4) -> np.ndarray:
    """Sequence-table SX1272 whitening (LoRaCodes.hpp:147-167).

    Each codeword bit i is XOR-ed with the whitening sequence at offset
    ``ofs[i] + j + bit_ofs`` (mod 510).  Vectorized over the buffer.
    """
    data = np.asarray(data, dtype=np.uint8)
    n = data.size
    ofs = _OFS1 if rdd == 1 else _OFS0
    nbits = 4 + rdd
    j = np.arange(n, dtype=np.int64)[:, None]
    t = (ofs[None, :nbits] + j + bit_ofs + _WHITEN_LEN) % _WHITEN_LEN
    bits = _WHITEN_BITS[t]  # (n, nbits)
    x = (bits << np.arange(nbits, dtype=np.uint8)[None, :]).sum(
        axis=1, dtype=np.uint32
    ).astype(np.uint8)
    return (data ^ x).astype(np.uint8)


_LFSR_SEED1 = (0x6572D100E85C2EFF, 0xE85C2EFFFFFFFFFF)
_LFSR_SEED2 = (0x05121100F8ECFEEF, 0xF8ECFEEFEFEFEFEF)
_M64 = (1 << 64) - 1


def _lfsr_step(r: int) -> int:
    """One byte-advance of the 64-bit shift register holding 8 interleaved
    bit-LFSRs with polynomial 0x1D (LoRaCodes.hpp:183)."""
    fb = ((r >> 32) ^ (r >> 24) ^ (r >> 16) ^ r) & 0xFF
    return ((r >> 8) | (fb << 56)) & _M64


def whitening_sequence_lfsr(n: int, bit_ofs: int = 0, rdd: int = 4) -> np.ndarray:
    """Per-byte whitening key of the dual-LFSR SX1272 variant.

    Two interleaved registers alternate per byte index (LoRaCodes.hpp:176-189);
    the output byte is the register's low byte masked to the active bit width.
    """
    mask = 0xFF >> (4 - rdd)
    seeds = _LFSR_SEED2 if rdd == 1 else _LFSR_SEED1
    r = [seeds[0], seeds[1]]
    for i in range(bit_ofs):
        r[i & 1] = _lfsr_step(r[i & 1])
    seq = np.zeros(n, dtype=np.uint8)
    i = bit_ofs
    for j in range(n):
        seq[j] = r[i & 1] & mask
        r[i & 1] = _lfsr_step(r[i & 1])
        i += 1
    return seq


def whiten_sx1272_lfsr(data, bit_ofs: int = 0, rdd: int = 4) -> np.ndarray:
    """Dual-LFSR SX1272 whitening (LoRaCodes.hpp:176-189). Involution."""
    data = np.asarray(data, dtype=np.uint8)
    key = whitening_sequence_lfsr(data.size, bit_ofs, rdd)
    return (data ^ key).astype(np.uint8)


# ---------------------------------------------------------------------------
# Gray mapping  --  LoRaCodes.hpp:201-222
# ---------------------------------------------------------------------------

def _word16(num):
    """A tensor's values as int32 16-bit words (the JAX package's uint16
    conversion), or host data as a numpy uint16 array."""
    if isinstance(num, torch.Tensor):
        return num.to(torch.int32) & 0xFFFF
    return np.asarray(num, dtype=np.uint16)


def binary_to_gray16(num):
    """Reflected binary Gray code, LSB-first (LoRaCodes.hpp:201-207).
    numpy uint16 from host data; int32 words from a tensor."""
    num = _word16(num)
    return num ^ (num >> 1)


def gray_to_binary16(num):
    """Inverse Gray mapping for <=16-bit words (LoRaCodes.hpp:212-222).
    numpy uint16 from host data; int32 words from a tensor."""
    num = _word16(num)
    num = num ^ (num >> 8)
    num = num ^ (num >> 4)
    num = num ^ (num >> 2)
    num = num ^ (num >> 1)
    return num


# ---------------------------------------------------------------------------
# FEC: Hamming(8,4)/(7,4) + parity codes  --  LoRaCodes.hpp:229-371
# The parity equations are evaluated once here to build lookup tables; the
# runtime path is a single table gather (host: numpy, device: tensor index).
# ---------------------------------------------------------------------------

def _ham_enc84(x: int) -> int:
    d0, d1, d2, d3 = (x >> 0) & 1, (x >> 1) & 1, (x >> 2) & 1, (x >> 3) & 1
    b = x & 0xF
    b |= (d0 ^ d1 ^ d2) << 4
    b |= (d1 ^ d2 ^ d3) << 5
    b |= (d0 ^ d1 ^ d3) << 6
    b |= (d0 ^ d2 ^ d3) << 7
    return b


def _ham_dec84(b: int) -> tuple[int, bool, bool]:
    bit = [(b >> i) & 1 for i in range(8)]
    p0 = bit[0] ^ bit[1] ^ bit[2] ^ bit[4]
    p1 = bit[1] ^ bit[2] ^ bit[3] ^ bit[5]
    p2 = bit[0] ^ bit[1] ^ bit[3] ^ bit[6]
    p3 = bit[0] ^ bit[2] ^ bit[3] ^ bit[7]
    parity = p0 | (p1 << 1) | (p2 << 2) | (p3 << 3)
    error = parity != 0
    # Syndromes that identify a correctable data-bit flip (LoRaCodes.hpp:268-280)
    flip = {0xD: 1, 0x7: 2, 0xB: 4, 0xE: 8}
    if parity in flip:
        return (b ^ flip[parity]) & 0xF, error, False
    if parity in (0x0, 0x1, 0x2, 0x4, 0x8):
        return b & 0xF, error, False
    return b & 0xF, error, True


def _ham_enc74(x: int) -> int:
    return _ham_enc84(x) & 0x7F


def _ham_dec74(b: int) -> tuple[int, bool]:
    bit = [(b >> i) & 1 for i in range(7)]
    p0 = bit[0] ^ bit[1] ^ bit[2] ^ bit[4]
    p1 = bit[1] ^ bit[2] ^ bit[3] ^ bit[5]
    p2 = bit[0] ^ bit[1] ^ bit[3] ^ bit[6]
    parity = p0 | (p1 << 1) | (p2 << 2)
    error = parity != 0
    flip = {0x5: 1, 0x7: 2, 0x3: 4, 0x6: 8}
    if parity in flip:
        return (b ^ flip[parity]) & 0xF, error
    return b & 0xF, error


HAMMING84_ENCODE_LUT = np.array([_ham_enc84(x) for x in range(16)], dtype=np.uint8)
_dec84 = [_ham_dec84(b) for b in range(256)]
HAMMING84_DECODE_LUT = np.array([d[0] for d in _dec84], dtype=np.uint8)
HAMMING84_ERROR_LUT = np.array([d[1] for d in _dec84], dtype=np.uint8)
HAMMING84_BAD_LUT = np.array([d[2] for d in _dec84], dtype=np.uint8)

HAMMING74_ENCODE_LUT = np.array([_ham_enc74(x) for x in range(16)], dtype=np.uint8)
_dec74 = [_ham_dec74(b & 0x7F) for b in range(128)]
HAMMING74_DECODE_LUT = np.array([d[0] for d in _dec74], dtype=np.uint8)
HAMMING74_ERROR_LUT = np.array([d[1] for d in _dec74], dtype=np.uint8)


def encode_hamming84(nibbles):
    """Vectorized SX Hamming(8,4) encode (LoRaCodes.hpp:229-242)."""
    n = np.asarray(nibbles)
    return HAMMING84_ENCODE_LUT[np.asarray(n & 0xF, dtype=np.uint8)]


def decode_hamming84(codewords, return_flags: bool = False):
    """Vectorized SX Hamming(8,4) decode with 1-bit correction
    (LoRaCodes.hpp:250-281). Only the low 8 bits participate, matching
    LoRaDecoder.cpp:15-17."""
    c = np.asarray(codewords, dtype=np.uint16) & 0xFF
    data = HAMMING84_DECODE_LUT[c]
    if return_flags:
        return data, HAMMING84_ERROR_LUT[c].astype(bool), HAMMING84_BAD_LUT[c].astype(bool)
    return data


def encode_hamming74(nibbles):
    """Vectorized SX Hamming(7,4) encode (LoRaCodes.hpp:287-299)."""
    n = np.asarray(nibbles)
    return HAMMING74_ENCODE_LUT[np.asarray(n & 0xF, dtype=np.uint8)]


def decode_hamming74(codewords, return_flags: bool = False):
    """Vectorized SX Hamming(7,4) decode (LoRaCodes.hpp:306-334)."""
    c = np.asarray(codewords, dtype=np.uint16) & 0x7F
    data = HAMMING74_DECODE_LUT[c]
    if return_flags:
        return data, HAMMING74_ERROR_LUT[c].astype(bool)
    return data


def encode_parity54(nibbles):
    """Single-parity 5/4 encode (LoRaCodes.hpp:347-351)."""
    b = np.asarray(nibbles, dtype=np.uint8) & 0xF
    x = b ^ (b >> 2)
    x = x ^ (x >> 1)
    return (b | ((x << 4) & 0x10)).astype(np.uint8)


def check_parity54(codewords, return_flags: bool = False):
    """Single-parity 5/4 check (LoRaCodes.hpp:340-345)."""
    b = np.asarray(codewords, dtype=np.uint8)
    x = b ^ (b >> 2)
    x = (x ^ (x >> 1) ^ (b >> 4)) & 1
    data = (b & 0xF).astype(np.uint8)
    if return_flags:
        return data, x.astype(bool)
    return data


def encode_parity64(nibbles):
    """Dual-parity 6/4 encode (LoRaCodes.hpp:367-371)."""
    b = np.asarray(nibbles, dtype=np.uint8) & 0xF
    x = b ^ (b >> 1) ^ (b >> 2)
    y = x ^ b ^ (b >> 3)
    return (((x & 1) << 4) | ((y & 1) << 5) | b).astype(np.uint8)


def check_parity64(codewords, return_flags: bool = False):
    """Dual-parity 6/4 check (LoRaCodes.hpp:357-365)."""
    b = np.asarray(codewords, dtype=np.uint8)
    x = b ^ (b >> 1) ^ (b >> 2)
    y = x ^ b ^ (b >> 3)
    x = (x ^ (b >> 4)) & 1
    y = (y ^ (b >> 5)) & 1
    data = (b & 0xF).astype(np.uint8)
    if return_flags:
        return data, ((x | y) & 1).astype(bool)
    return data


# ---------------------------------------------------------------------------
# Diagonal interleaver  --  LoRaCodes.hpp:376-412
# Expressed as gathers over a precomputed (nb, ppm) index grid, so numpy and
# torch run the same formulation (no scatter in either direction).
# ---------------------------------------------------------------------------

def _interleave_grids(ppm: int, nb: int):
    """(src, bit, cwi) of the interleaver: the (nb, ppm) gather map (int64)
    and the bit and codeword shift grids (int32)."""
    bit = np.arange(nb, dtype=np.int32)[:, None]          # (nb, 1)
    cwi = np.arange(ppm, dtype=np.int32)[None, :]         # (1, ppm)
    src = ((cwi + bit) % ppm).astype(np.int64)            # (nb, ppm)
    return src, bit, cwi


def _deinterleave_grids(ppm: int, nb: int):
    """(pos, bit) of the deinterleaver: the (ppm, nb) source symbol-bit
    positions and the bit shift grid, int32."""
    d = np.arange(ppm, dtype=np.int32)[:, None]           # (ppm, 1)
    bit = np.arange(nb, dtype=np.int32)[None, :]          # (1, nb)
    return (d - bit) % ppm, bit


def _grids(make, ppm: int, nb: int, like):
    """``make(ppm, nb)`` as numpy (host input) or as tensors cached on the
    input's device (``device_table``): a call on the card copies no grid
    from the host after the first."""
    if isinstance(like, torch.Tensor):
        return device_table(make, ppm, nb, device=like.device)
    return make(ppm, nb)


def diagonal_interleave(codewords, ppm: int, rdd: int):
    """Diagonal bit interleaver: ppm codewords x (4+rdd) bits -> (4+rdd)
    symbols of ppm bits (LoRaCodes.hpp:376-393).

    ``sym[blk, bit]`` collects bit ``bit`` of codeword ``(cw + bit) % ppm``
    into symbol bit position ``cw``.  numpy uint16 from host data; int32
    words from a tensor.
    """
    cw = _word16(codewords)
    nblk = cw.shape[-1] // ppm
    nb = 4 + rdd
    cw = cw[..., : nblk * ppm].reshape(cw.shape[:-1] + (nblk, ppm))
    src, bit, cwi = _grids(_interleave_grids, ppm, nb, cw)
    g = cw[..., src]                      # (..., nblk, nb, ppm)
    if isinstance(cw, torch.Tensor):
        b = (g >> bit) & 1
        sym = (b << cwi).sum(dim=-1, dtype=torch.int32)
        sym = sym & 0xFFFF
    else:
        b = (g >> bit[None].astype(np.uint16)) & np.uint16(1)
        sym = (b << cwi[None].astype(np.uint16)).sum(axis=-1)
        sym = sym.astype(np.uint16)
    return sym.reshape(sym.shape[:-2] + (nblk * nb,))


def diagonal_deinterleave(symbols, ppm: int, rdd: int):
    """Exact inverse of :func:`diagonal_interleave` (LoRaCodes.hpp:396-412).

    ``cw[blk, d]`` rebuilds bit ``bit`` from symbol ``bit`` at symbol bit
    position ``(d - bit) % ppm`` -- a pure gather, no scatter.  numpy uint8
    from host data; int32 bytes (``& 0xFF``) from a tensor.
    """
    sym = _word16(symbols)
    nb = 4 + rdd
    nblk = sym.shape[-1] // nb
    sym = sym[..., : nblk * nb].reshape(sym.shape[:-1] + (nblk, nb))
    pos, bit = _grids(_deinterleave_grids, ppm, nb, sym)
    s = sym[..., None, :]                 # (..., nblk, 1, nb)
    if isinstance(sym, torch.Tensor):
        b = (s >> pos) & 1
        cw = (b << bit).sum(dim=-1, dtype=torch.int32)
        cw = cw & 0xFF
    else:
        b = (s >> pos[None].astype(np.uint16)) & np.uint16(1)
        cw = (b << bit[None].astype(np.uint16)).sum(axis=-1)
        cw = cw.astype(np.uint8)
    return cw.reshape(cw.shape[:-2] + (nblk * ppm,))

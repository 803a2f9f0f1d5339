"""Plain LoRa PHY reference: parameters, modulator, raw and SX1272 codecs.

The benchmark's own implementation of what it feeds the program and of
what it expects back.  It follows the semantics of the Semtech SX1272
datasheet and of the LoRa-SDR reference's ``LoRaMod.cpp``,
``LoRaCodes.hpp``, ``LoRaEncoder.cpp`` and ``LoRaDecoder.cpp``, in plain
PyTorch and Python integers: no table or kernel of the program under test,
and nothing it builds.

The modulator works in exact integer phase numerators (phase = pi * num /
D, D = n * osr^2) and takes cos/sin in float64, so its chirps are exact to
float64 rounding; ``prec="tf32"`` rounds its output to TF32's 10-bit
mantissa (the control of ``portbench/check.py``).  Integers are int64
throughout.
"""
from __future__ import annotations

import dataclasses
import math

import torch

__all__ = ["Phy", "tf32_round", "modulate", "ham84_encode", "ham84_decode",
           "crc_sx1272", "crc_sx1272_at", "encode_raw", "decode_raw",
           "frame_symbols", "encode_frame", "decode_frame_padded"]


@dataclasses.dataclass(frozen=True)
class Phy:
    """One LoRa PHY configuration (``portbench/configs/*.json``)."""

    sf: int
    bw: int
    cr: str = "4/5"
    osr: int = 1
    sync_word: int = 0x12

    @property
    def n(self) -> int:
        return 1 << self.sf

    @property
    def step(self) -> int:
        return self.n * self.osr

    @property
    def bw_scale(self) -> int:
        return self.bw // 125000

    @property
    def rdd(self) -> int:
        num, den = self.cr.split("/")
        return int(den) - int(num)

    @property
    def sample_rate(self) -> int:
        return self.bw * self.osr

    def sync_symbols(self) -> tuple[int, int]:
        """The two sync-word chirps' symbol values (LoRaMod.cpp:20-22)."""
        shift = self.sf - 4 if self.sf > 4 else 0
        return (((self.sync_word >> 4) << shift) & 0xFFFF,
                ((self.sync_word & 0xF) << shift) & 0xFFFF)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32 (10 mantissa bits), to nearest even:
    what a TF32 tensor-core product does to its operands."""
    b = x.to(torch.float32).contiguous().view(torch.int32)
    lsb = (b >> 13) & 1
    b = (b + 0xFFF + lsb) & ~0x1FFF
    return b.view(torch.float32)


# ---------------------------------------------------------------------------
# Modulator (LoRaMod.cpp:8-43, ChirpGenerator.hpp:24-51)
# ---------------------------------------------------------------------------

def _wraps(t, b: int):
    """sum_{j < t} j // b, exact."""
    q = t // b
    return b * (q * (q - 1) // 2) + q * (t - q * b)


def _numerators(sym, phy: Phy):
    """Phase numerators (mod 2D) of the up-chirps of ``sym`` (..., S) at
    sample m = 1 .. n*osr of each symbol: (..., S, n*osr) int64."""
    n, osr, bs = phy.n, phy.osr, phy.bw_scale
    b = n * osr
    two_d = 2 * n * osr * osr
    m = torch.arange(1, b + 1, dtype=torch.int64, device=sym.device)
    c = sym[..., None] * osr
    w = _wraps(c + m, b) - _wraps(c, b)
    num = -m * b + 2 * sym[..., None] * m * osr + m * (m + 1) - 2 * w * b
    return torch.remainder(torch.remainder(num, two_d) * bs, two_d)


def modulate(symbols, phy: Phy, dechirped: bool = False,
             prec: str = "f64"):
    """Symbols (..., S) -> IQ planes (..., (S + 2) * step): the two sync
    chirps, then one phase-continuous up-chirp per symbol.  With
    ``dechirped`` each symbol window is multiplied by the base down-chirp
    (the golden-vector dechirp step), which in integer phase is a
    subtraction.  float64 out (``prec="f64"``) or TF32-rounded float32."""
    sym = symbols.to(torch.int64)
    sw0, sw1 = phy.sync_symbols()
    lead = sym.shape[:-1]
    sync = torch.tensor([sw0, sw1], dtype=torch.int64,
                        device=sym.device).expand(lead + (2,))
    allsyms = torch.cat([sync, sym], dim=-1)
    two_d = 2 * phy.n * phy.osr * phy.osr
    num = _numerators(allsyms, phy)
    # phase carried across symbols: the end numerator of each symbol
    end = num[..., -1]
    start = torch.remainder(torch.cumsum(end, dim=-1) - end, two_d)
    num = torch.remainder(num + start[..., None], two_d)
    if dechirped:
        base = _numerators(torch.zeros((1,), dtype=torch.int64,
                                       device=sym.device), phy)[0]
        num = torch.remainder(num - base, two_d)
    phi = num.to(torch.float64) * (2.0 * math.pi / two_d)
    re = torch.cos(phi).reshape(lead + (-1,))
    im = torch.sin(phi).reshape(lead + (-1,))
    if prec == "tf32":
        return tf32_round(re), tf32_round(im)
    return re, im


# ---------------------------------------------------------------------------
# Raw codec: one Hamming(8,4) codeword per nibble (LoRaEncoder.cpp:6-18,
# LoRaDecoder.cpp:7-21), SX1272 CRC over bytes 2 .. k-3 (phy.cpp:245-261)
# ---------------------------------------------------------------------------

def ham84_encode(nib):
    d = [(nib >> i) & 1 for i in range(4)]
    return ((nib & 0xF) | ((d[0] ^ d[1] ^ d[2]) << 4)
            | ((d[1] ^ d[2] ^ d[3]) << 5) | ((d[0] ^ d[1] ^ d[3]) << 6)
            | ((d[0] ^ d[2] ^ d[3]) << 7))


def _ham84_syndrome(c):
    b = [(c >> i) & 1 for i in range(8)]
    p0 = b[0] ^ b[1] ^ b[2] ^ b[4]
    p1 = b[1] ^ b[2] ^ b[3] ^ b[5]
    p2 = b[0] ^ b[1] ^ b[3] ^ b[6]
    p3 = b[0] ^ b[2] ^ b[3] ^ b[7]
    return p0 | (p1 << 1) | (p2 << 2) | (p3 << 3)


_HAM84_FLIP = {0xD: 1, 0x7: 2, 0xB: 4, 0xE: 8}


def ham84_decode(c):
    """(nibble, error flag) of Hamming(8,4) codewords: a syndrome that
    names a data bit flips it; any other non-zero syndrome is an error."""
    c = c & 0xFF
    s = _ham84_syndrome(c)
    flip = torch.zeros_like(c)
    for syn, bit in _HAM84_FLIP.items():
        flip = torch.where(s == syn, bit, flip)
    return (c ^ flip) & 0xF, s != 0


def _crc_step_table() -> list[int]:
    """CCITT 0x1021, eight shifts of byte << 8."""
    out = []
    for byte in range(256):
        crc = byte << 8
        for _ in range(8):
            crc = ((crc << 1) ^ 0x1021) if crc & 0x8000 else (crc << 1)
            crc &= 0xFFFF
        out.append(crc)
    return out


def _mask_bytes(count: int) -> list[int]:
    """The SX1272 CRC's masking LFSR: v0 = 0xFF, v' = parity(v & 0xB8) |
    (v << 1)."""
    out, v = [], 0xFF
    for _ in range(count):
        out.append(v)
        v = ((bin(v & 0xB8).count("1") & 1) | (v << 1)) & 0xFF
    return out


def crc_sx1272_at(data, length):
    """SX1272 payload CRC (LoRaCodes.hpp:92-105) of the first ``length[r]``
    bytes of each row of ``data`` (R, L): int64 (R,)."""
    d = data.to(torch.int64)
    dev = d.device
    table = torch.tensor(_crc_step_table(), dtype=torch.int64, device=dev)
    length = length.to(torch.int64)
    res = torch.zeros(d.shape[0], dtype=torch.int64, device=dev)
    for i in range(d.shape[1]):
        nxt = (((res << 8) & 0xFFFF) ^ table[res >> 8]) ^ d[:, i]
        res = torch.where(i < length, nxt, res)
    v = torch.tensor(_mask_bytes(d.shape[1] + 2), dtype=torch.int64,
                     device=dev)
    return (res ^ v[length] ^ (v[length + 1] << 8)) & 0xFFFF


def crc_sx1272(data):
    """SX1272 CRC of every byte of each row."""
    return crc_sx1272_at(data, torch.full((data.shape[0],), data.shape[1],
                                          device=data.device))


def encode_raw(payload):
    """Bytes (..., L) -> 2L symbols, high nibble first."""
    p = payload.to(torch.int64)
    sym = torch.stack([ham84_encode(p >> 4), ham84_encode(p & 0xF)], dim=-1)
    return sym.reshape(p.shape[:-1] + (-1,))


def decode_raw(symbols):
    """Symbols (R, 2L) -> (bytes (R, L) int64, crc_ok (R,) bool): the last
    two bytes hold the CRC of bytes 2 .. L-3, little-endian."""
    nib, _ = ham84_decode(symbols.to(torch.int64))
    by = (nib[:, 0::2] << 4) | nib[:, 1::2]
    k = by.shape[1]
    if k < 4:
        return by, torch.zeros(by.shape[0], dtype=torch.bool,
                               device=by.device)
    calc = crc_sx1272(by[:, 2:k - 2])
    return by, (by[:, k - 2] | (by[:, k - 1] << 8)) == calc


# ---------------------------------------------------------------------------
# SX1272 frame: explicit header, whitening, FEC at the coding rate,
# diagonal interleave, Gray (LoRaCodes.hpp:43-412)
# ---------------------------------------------------------------------------

HEADER_SYMBOLS = 8
HEADER_CODEWORDS = 5
# 5-bit header checksum: output bits 4..0 over the 12 input bits
# [h0 bits 7..0, h1 bits 3..0]
_HDR_PARITY = ((1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0),
               (1, 0, 0, 0, 1, 1, 1, 0, 0, 0, 0, 1),
               (0, 1, 0, 0, 1, 0, 0, 1, 1, 0, 1, 0),
               (0, 0, 1, 0, 0, 1, 0, 1, 0, 1, 1, 1),
               (0, 0, 0, 1, 0, 0, 1, 0, 1, 1, 1, 1))
_LFSR_SEEDS = (0x6572D100E85C2EFF, 0xE85C2EFFFFFFFFFF)


def _header_checksum(h0, h1):
    bits = [(h0 >> s) & 1 for s in range(7, -1, -1)] + \
           [(h1 >> s) & 1 for s in range(3, -1, -1)]
    out = torch.zeros_like(h0)
    for row in _HDR_PARITY:
        x = torch.zeros_like(h0)
        for bit, on in zip(bits, row):
            if on:
                x = x ^ bit
        out = (out << 1) | x
    return out


def _whitening(count: int, cap: int, rdd: int) -> list[int]:
    """Per-codeword whitening keys: the dual 8-bit LFSR bytes (poly 0x1D,
    two registers alternating, LoRaCodes.hpp:176-189), masked to 8 bits on
    the ``cap`` header-block codewords and to 4 + rdd bits after them."""
    r = list(_LFSR_SEEDS)
    out = []
    for j in range(count):
        width = 0xFF if j < cap else 0xFF >> (4 - rdd)
        out.append(r[j & 1] & 0xFF & width)
        x = r[j & 1]
        fb = ((x >> 32) ^ (x >> 24) ^ (x >> 16) ^ x) & 0xFF
        r[j & 1] = ((x >> 8) | (fb << 56)) & ((1 << 64) - 1)
    return out


def _fec_encode(nib, rdd: int):
    """Codewords of the coding rate 4/(4 + rdd)."""
    if rdd >= 3:
        return ham84_encode(nib) & (0xFF if rdd == 4 else 0x7F)
    b = nib & 0xF
    if rdd == 2:
        x = b ^ (b >> 1) ^ (b >> 2)
        y = x ^ b ^ (b >> 3)
        return b | ((x & 1) << 4) | ((y & 1) << 5)
    x = b ^ (b >> 2)
    x = x ^ (x >> 1)
    return b | ((x & 1) << 4)


def _fec_decode(c, rdd: int):
    """(nibble, error flag): Hamming 8/4 and 7/4 correct one data bit,
    the parity codes only detect."""
    if rdd == 4:
        return ham84_decode(c)
    if rdd == 3:
        c = c & 0x7F
        b = [(c >> i) & 1 for i in range(7)]
        s = ((b[0] ^ b[1] ^ b[2] ^ b[4]) | ((b[1] ^ b[2] ^ b[3] ^ b[5]) << 1)
             | ((b[0] ^ b[1] ^ b[3] ^ b[6]) << 2))
        flip = torch.zeros_like(c)
        for syn, bit in {0x5: 1, 0x7: 2, 0x3: 4, 0x6: 8}.items():
            flip = torch.where(s == syn, bit, flip)
        return (c ^ flip) & 0xF, s != 0
    c = c & (0x3F if rdd == 2 else 0x1F)
    b = c & 0xF
    if rdd == 2:
        x = b ^ (b >> 1) ^ (b >> 2)
        y = x ^ b ^ (b >> 3)
        bad = (((x ^ (c >> 4)) | (y ^ (c >> 5))) & 1) != 0
    else:
        x = b ^ (b >> 2)
        bad = ((x ^ (x >> 1) ^ (c >> 4)) & 1) != 0
    return b, bad


def _interleave(cw, ppm: int, rdd: int):
    """Codewords (..., blocks * ppm) -> symbols (..., blocks * (4 + rdd)):
    bit ``cw_i`` of symbol ``bit`` is bit ``bit`` of codeword
    ``(cw_i + bit) % ppm``."""
    nb = 4 + rdd
    blocks = cw.shape[-1] // ppm
    cw = cw.reshape(cw.shape[:-1] + (blocks, ppm))
    out = []
    for bit in range(nb):
        s = torch.zeros_like(cw[..., 0])
        for i in range(ppm):
            s = s | (((cw[..., (i + bit) % ppm] >> bit) & 1) << i)
        out.append(s)
    return torch.stack(out, dim=-1).reshape(cw.shape[:-2] + (blocks * nb,))


def _deinterleave(sym, ppm: int, rdd: int):
    """Inverse of ``_interleave``."""
    nb = 4 + rdd
    blocks = sym.shape[-1] // nb
    sym = sym.reshape(sym.shape[:-1] + (blocks, nb))
    out = []
    for d in range(ppm):
        c = torch.zeros_like(sym[..., 0])
        for bit in range(nb):
            c = c | (((sym[..., bit] >> ((d - bit) % ppm)) & 1) << bit)
        out.append(c)
    return torch.stack(out, dim=-1).reshape(sym.shape[:-2] + (blocks * ppm,))


def _gray_to_binary(x):
    for s in (8, 4, 2, 1):
        x = x ^ (x >> s)
    return x


def _binary_to_gray(x):
    return x ^ (x >> 1)


def _geometry(phy: Phy, length: int, crc: bool = True):
    """(payload nibbles, ride-along capacity, body blocks, symbols)."""
    if phy.sf < 7:
        raise ValueError("the SX1272 frame needs sf >= 7")
    nib = 2 * (length + (2 if crc else 0))
    cap = phy.sf - 2 - HEADER_CODEWORDS
    blocks = -(-max(0, nib - cap) // phy.sf)
    return nib, cap, blocks, HEADER_SYMBOLS + blocks * (4 + phy.rdd)


def frame_symbols(phy: Phy, length: int, crc: bool = True) -> int:
    return _geometry(phy, length, crc)[3]


def encode_frame(payload, phy: Phy, crc: bool = True, crc_of=None):
    """Payload bytes (R, L), every row of length L -> on-air symbols (R,
    frame_symbols(L)) int64, the sync prelude not included.  The CRC is
    that of ``crc_of`` (default: the payload itself), so a frame altered
    after its CRC can be made."""
    p = payload.to(torch.int64)
    dev = p.device
    rows, length = p.shape
    nib_total, cap, blocks, _ = _geometry(phy, length, crc)
    sf, rdd = phy.sf, phy.rdd
    if crc:
        c = crc_sx1272(p if crc_of is None else crc_of)
        p = torch.cat([p, (c & 0xFF)[:, None], (c >> 8)[:, None]], dim=1)
    nib = torch.stack([p >> 4, p & 0xF], dim=-1).reshape(rows, nib_total)
    n_cw = cap + blocks * sf
    nib = torch.nn.functional.pad(nib, (0, max(0, n_cw - nib_total)))
    keys = torch.tensor(_whitening(n_cw, cap, rdd), dtype=torch.int64,
                        device=dev)
    cw_head = ham84_encode(nib[:, :cap]) ^ keys[:cap]
    cw_body = _fec_encode(nib[:, cap:], rdd) ^ keys[cap:]
    h0 = torch.full((rows,), length & 0xFF, dtype=torch.int64, device=dev)
    h1 = torch.full((rows,), ((rdd << 1) | int(crc)) & 0xF,
                    dtype=torch.int64, device=dev)
    chk = _header_checksum(h0, h1)
    hdr = ham84_encode(torch.stack([h0 >> 4, h0 & 0xF, h1, chk >> 4,
                                    chk & 0xF], dim=1))
    blk0 = torch.cat([hdr, cw_head], dim=1)
    air = (_gray_to_binary(_interleave(blk0, sf - 2, 4)) << 2) & (phy.n - 1)
    if blocks:
        air = torch.cat([air, _gray_to_binary(_interleave(cw_body, sf, rdd))],
                        dim=1)
    return air


def decode_frame_padded(symbols, phy: Phy, max_len: int, crc: bool = True):
    """Symbols (R, >= frame_symbols(max_len)) -> dict of (R,)-tensors and
    the (R, max_len) payload, zero past each row's length: the header is
    read from every row, the length taken from it (clamped to
    ``max_len``), and the frame's CRC checked over that many bytes."""
    s = symbols.to(torch.int64)
    dev = s.device
    sf, rdd = phy.sf, phy.rdd
    _, cap, max_blocks, need = _geometry(phy, max_len, crc)
    if s.shape[1] < need:
        raise ValueError(f"need {need} symbols, got {s.shape[1]}")
    n_cw = cap + max_blocks * sf
    keys = torch.tensor(_whitening(n_cw, cap, rdd), dtype=torch.int64,
                        device=dev)
    # header block on the reduced grid, snapped with rounding
    g = _binary_to_gray(((s[:, :HEADER_SYMBOLS] + 2) >> 2)
                        & ((1 << (sf - 2)) - 1))
    cw = _deinterleave(g, sf - 2, 4)
    hdr_nib, hdr_err = ham84_decode(cw[:, :HEADER_CODEWORDS])
    ride_nib, ride_err = ham84_decode(cw[:, HEADER_CODEWORDS:] ^ keys[:cap])
    h0 = (hdr_nib[:, 0] << 4) | hdr_nib[:, 1]
    h1 = hdr_nib[:, 2]
    chk = ((hdr_nib[:, 3] & 1) << 4) | hdr_nib[:, 4]
    rdd_f = (h1 >> 1) & 7
    crc_en = (h1 & 1) == 1
    hdr_ok = ((_header_checksum(h0, h1) == chk) & (hdr_nib[:, 3] <= 1)
              & (rdd_f >= 1) & (rdd_f <= 4) & (h0 >= 1))
    n_err = hdr_err.sum(dim=1) + ride_err.sum(dim=1)
    body = s[:, HEADER_SYMBOLS:HEADER_SYMBOLS + max_blocks * (4 + rdd)]
    body_cw = _deinterleave(_binary_to_gray(body & (phy.n - 1)), sf, rdd)
    body_nib, body_err = _fec_decode(body_cw ^ keys[cap:], rdd)
    nib = torch.cat([ride_nib, body_nib], dim=1)
    n_bytes = n_cw // 2
    by = (nib[:, 0:2 * n_bytes:2] << 4) | nib[:, 1:2 * n_bytes:2]
    length = torch.clamp(h0, 0, max_len)
    used = torch.clamp(2 * (length + torch.where(crc_en, 2, 0)) - cap, 0,
                       max_blocks * sf)
    pos = torch.arange(body_err.shape[1], device=dev)
    n_err = n_err + (body_err & (pos < used[:, None])).sum(dim=1)
    if crc:
        calc = crc_sx1272_at(by, length)
        c0 = by.gather(1, torch.clamp(length, 0, n_bytes - 1)[:, None])[:, 0]
        c1 = by.gather(1, torch.clamp(length + 1, 0, n_bytes - 1)[:, None])[:, 0]
        room = (length + 2) * 2 <= n_cw
        crc_ok = hdr_ok & crc_en & room & ((c0 | (c1 << 8)) == calc)
    else:
        crc_ok = hdr_ok & ~crc_en
    ok_len = hdr_ok & (h0 <= max_len) & (rdd_f == rdd)
    idx = torch.arange(max_len, device=dev)
    src = torch.clamp(idx, 0, n_bytes - 1)
    payload = torch.where(idx < length[:, None], by[:, src], 0)
    return {"payload": payload, "length": length, "hdr_ok": ok_len,
            "crc_ok": crc_ok & ok_len, "n_err": n_err}

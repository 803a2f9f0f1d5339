"""SX1272 CRC-16 tables (masked CCITT), LoRaCodes.hpp:69-105.

The CRC part of ``lora_sdr_lightweight_standalone_library_clean_tpu/ops/
codes.py`` (its lines 120-183), pure numpy like the original: the 256-entry
CCITT step table and the LFSR masking bytes that ``models/modem.py::
crc_sx1272`` folds into its GF(2) matrix product.  The rest of the coding
toolbox (whitening, Gray mapping, FEC, interleaving) belongs to the framing
slice.
"""
from __future__ import annotations

import numpy as np

__all__ = ["crc16sx", "xsum8", "crc16_table", "crc_mask_pair"]


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

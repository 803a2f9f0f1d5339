"""LoRaWAN MAC helper: frames, AES-CMAC MIC, build/parse.

PyTorch port of ``lora_sdr_lightweight_standalone_library_clean_tpu/models/
lorawan.py``: the host control plane mirroring the reference MAC layer
(``src/lorawan/lorawan.cpp``, ``include/lorawan/lorawan.hpp``).  Per-frame
crypto is small and sequential, so it runs on the host, through the native
C++ AES/CMAC (``utils/native.py``) or, where that library cannot be built,
the pure-Python AES the JAX package also keeps.  The PHY symbols go through
the port's own ``encode``/``decode`` on the card (``build_frame`` places
them on ``device``, the CUDA card unless the caller asks for the CPU);
``parse_frame`` moves the decoded bytes to the host.

Parity map:
 - ``compute_mic``  -> lorawan.cpp:35-98  (B0 block || msg, CMAC, 4 LE bytes)
 - ``build_frame``  -> lorawan.cpp:100-136
 - ``parse_frame``  -> lorawan.cpp:138-177 (MIC verify, FOpts bounds check)
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field

import numpy as np
import torch

from ..utils import native
from ..utils.errors import (InvalidArgumentError, MicMismatchError,
                            RangeError)
from ..utils.tensors import host_device
from .modem import decode as phy_decode, encode as phy_encode

__all__ = ["MType", "MHDR", "FHDR", "MACCommand", "Frame",
           "compute_mic", "build_frame", "parse_frame", "aes128_encrypt_block"]


class MType(enum.IntEnum):
    JOIN_REQUEST = 0
    JOIN_ACCEPT = 1
    UNCONFIRMED_DATA_UP = 2
    UNCONFIRMED_DATA_DOWN = 3
    CONFIRMED_DATA_UP = 4
    CONFIRMED_DATA_DOWN = 5
    RFU = 6
    PROPRIETARY = 7


@dataclass
class MHDR:
    mtype: MType = MType.UNCONFIRMED_DATA_UP
    major: int = 0


@dataclass
class MACCommand:
    cid: int = 0
    payload: bytes = b""


@dataclass
class FHDR:
    devaddr: int = 0
    fctrl: int = 0          # low nibble re-derived from len(fopts) on build
    fcnt: int = 0
    fopts: bytes = b""


@dataclass
class Frame:
    mhdr: MHDR = field(default_factory=MHDR)
    fhdr: FHDR = field(default_factory=FHDR)
    payload: bytes = b""


# ---------------------------------------------------------------------------
# Pure-Python AES-128 fallback (FIPS-197; the S-box is computed on first use)
# ---------------------------------------------------------------------------

def _gf_mul(a: int, b: int) -> int:
    p = 0
    while b:
        if b & 1:
            p ^= a
        a = ((a << 1) ^ 0x1B) & 0xFF if a & 0x80 else (a << 1) & 0xFF
        b >>= 1
    return p


def _build_sbox() -> list[int]:
    inv = [0] * 256
    for a in range(1, 256):
        for b in range(1, 256):
            if _gf_mul(a, b) == 1:
                inv[a] = b
                break
    sbox = []
    for i in range(256):
        x = y = inv[i]
        for _ in range(4):
            y = ((y << 1) | (y >> 7)) & 0xFF
            x ^= y
        sbox.append(x ^ 0x63)
    return sbox


_SBOX: list[int] | None = None


def _aes_encrypt_py(key: bytes, block: bytes) -> bytes:
    global _SBOX
    if _SBOX is None:
        _SBOX = _build_sbox()
    sbox = _SBOX
    rk = [list(key)]
    rcon = 1
    for _ in range(10):
        prev = rk[-1]
        t = [sbox[prev[13]] ^ rcon, sbox[prev[14]], sbox[prev[15]],
             sbox[prev[12]]]
        rcon = _gf_mul(rcon, 2)
        out = [prev[i] ^ t[i] for i in range(4)]
        for i in range(4, 16):
            out.append(prev[i] ^ out[i - 4])
        rk.append(out)
    s = [b ^ k for b, k in zip(block, rk[0])]
    for rnd in range(1, 11):
        s = [sbox[b] for b in s]
        s = [s[r + 4 * ((c + r) % 4)] for c in range(4) for r in range(4)]
        if rnd != 10:
            ns = []
            for c in range(4):
                a0, a1, a2, a3 = s[4 * c: 4 * c + 4]
                ns += [
                    _gf_mul(a0, 2) ^ _gf_mul(a1, 3) ^ a2 ^ a3,
                    a0 ^ _gf_mul(a1, 2) ^ _gf_mul(a2, 3) ^ a3,
                    a0 ^ a1 ^ _gf_mul(a2, 2) ^ _gf_mul(a3, 3),
                    _gf_mul(a0, 3) ^ a1 ^ a2 ^ _gf_mul(a3, 2),
                ]
            s = ns
        s = [b ^ k for b, k in zip(s, rk[rnd])]
    return bytes(s)


def aes128_encrypt_block(key: bytes, block: bytes) -> bytes:
    """AES-128 ECB single block (native C++ when available)."""
    out = native.aes_ecb_encrypt(bytes(key), bytes(block))
    if out is not None:
        return out
    return _aes_encrypt_py(bytes(key), bytes(block))


def _shift_left(b: bytes) -> bytes:
    out = bytearray(16)
    carry = 0
    for i in range(15, -1, -1):
        out[i] = ((b[i] << 1) | carry) & 0xFF
        carry = (b[i] >> 7) & 1
    return bytes(out)


def _cmac_py(key: bytes, msg: bytes) -> bytes:
    l = aes128_encrypt_block(key, bytes(16))
    k1 = _shift_left(l)
    if l[0] & 0x80:
        k1 = k1[:15] + bytes([k1[15] ^ 0x87])
    k2 = _shift_left(k1)
    if k1[0] & 0x80:
        k2 = k2[:15] + bytes([k2[15] ^ 0x87])
    n = (len(msg) + 15) // 16
    complete = n != 0 and len(msg) % 16 == 0
    if n == 0:
        n = 1
    x = bytes(16)
    for i in range(n - 1):
        blk = bytes(a ^ b for a, b in zip(msg[16 * i: 16 * i + 16], x))
        x = aes128_encrypt_block(key, blk)
    last = bytearray(msg[16 * (n - 1):].ljust(16, b"\0"))
    if complete:
        sub = k1
    else:
        last[len(msg) - 16 * (n - 1)] = 0x80
        sub = k2
    blk = bytes(a ^ b ^ c for a, b, c in zip(last, sub, x))
    return aes128_encrypt_block(key, blk)


def _mic_py(nwk_skey: bytes, uplink: bool, devaddr: int, fcnt: int,
            data: bytes) -> int:
    """The MIC through the pure-Python CMAC (B0 block per LoRaWAN 1.0)."""
    b0 = bytearray(16)
    b0[0] = 0x49
    b0[5] = 0 if uplink else 1
    b0[6:10] = devaddr.to_bytes(4, "little")
    b0[10:14] = fcnt.to_bytes(4, "little")
    b0[14] = (len(data) >> 8) & 0xFF
    b0[15] = len(data) & 0xFF
    mac = _cmac_py(bytes(nwk_skey), bytes(b0) + bytes(data))
    return int.from_bytes(mac[:4], "little")


def compute_mic(nwk_skey: bytes, uplink: bool, devaddr: int, fcnt: int,
                data: bytes) -> int:
    """LoRaWAN MIC: AES-CMAC over B0 || msg, first 4 bytes LE
    (lorawan.cpp:35-98)."""
    mic = native.wan_mic(bytes(nwk_skey), uplink, devaddr, fcnt, bytes(data))
    if mic is not None:
        return mic
    return _mic_py(nwk_skey, uplink, devaddr, fcnt, data)


def serialize_frame(nwk_skey: bytes, frame: Frame) -> bytes:
    """MHDR|devaddr|FCtrl|FCnt|FOpts|FRMPayload|MIC (lorawan.cpp:110-134)."""
    if len(frame.fhdr.fopts) > 15:
        raise RangeError("FOpts longer than 15 bytes")
    out = bytearray()
    mhdr = ((int(frame.mhdr.mtype) & 0x7) << 5) | (frame.mhdr.major & 0x3)
    out.append(mhdr)
    out += frame.fhdr.devaddr.to_bytes(4, "little")
    fctrl = (frame.fhdr.fctrl & 0xF0) | (len(frame.fhdr.fopts) & 0x0F)
    out.append(fctrl)
    out += (frame.fhdr.fcnt & 0xFFFF).to_bytes(2, "little")
    out += bytes(frame.fhdr.fopts)
    out += bytes(frame.payload)
    uplink = (int(frame.mhdr.mtype) & 1) == 0
    mic = compute_mic(nwk_skey, uplink, frame.fhdr.devaddr, frame.fhdr.fcnt,
                      bytes(out))
    out += mic.to_bytes(4, "little")
    return bytes(out)


def build_frame(nwk_skey: bytes, frame: Frame, symbol_cap: int | None = None,
                device=None):
    """Serialize + MIC + PHY encode -> int32 symbols on ``device``
    (lorawan.cpp:100-136)."""
    if frame is None or nwk_skey is None:
        raise InvalidArgumentError("frame and key required")
    wire = serialize_frame(nwk_skey, frame)
    wire_t = torch.as_tensor(np.frombuffer(wire, np.uint8).copy(),
                             device=host_device(device))
    syms = phy_encode(wire_t[None])
    if symbol_cap is not None and syms.shape[-1] > symbol_cap:
        raise RangeError(f"{syms.shape[-1]} symbols exceed cap {symbol_cap}")
    return syms[0]


def parse_frame(nwk_skey: bytes, symbols) -> Frame:
    """PHY decode -> MIC verify -> field extraction (lorawan.cpp:138-177).

    ``symbols`` is a tensor (its device decodes) or host data (decoded on
    the card).  Raises RangeError when shorter than the 12-byte minimum or
    on FOpts overrun; MicMismatchError (errno EINVAL) on MIC failure.
    """
    if nwk_skey is None or symbols is None:
        raise InvalidArgumentError("key and symbols required")
    if not isinstance(symbols, torch.Tensor):
        symbols = np.asarray(symbols)
    payload, _ = phy_decode(symbols[None], check_crc=False)
    data = bytes(payload[0].cpu().numpy())
    if len(data) < 1 + 4 + 1 + 2 + 4:
        raise RangeError(f"frame too short: {len(data)} bytes")
    mhdr = data[0]
    devaddr = int.from_bytes(data[1:5], "little")
    fcnt = int.from_bytes(data[6:8], "little")
    uplink = ((mhdr >> 5) & 1) == 0
    mic = int.from_bytes(data[-4:], "little")
    calc = compute_mic(nwk_skey, uplink, devaddr, fcnt, data[:-4])
    if mic != calc:
        raise MicMismatchError(
            f"MIC mismatch: frame {mic:#010x} != computed {calc:#010x}")
    frame = Frame()
    frame.mhdr.mtype = MType(mhdr >> 5)
    frame.mhdr.major = mhdr & 0x3
    frame.fhdr.devaddr = devaddr
    frame.fhdr.fctrl = data[5]
    fopts_len = data[5] & 0x0F
    frame.fhdr.fcnt = fcnt
    if 8 + fopts_len > len(data) - 4:
        raise RangeError("FOpts overruns frame body")
    frame.fhdr.fopts = data[8: 8 + fopts_len]
    frame.payload = data[8 + fopts_len: len(data) - 4]
    return frame

"""Readers for the reference golden-vector binary formats.

The port's own copy of ``lora_sdr_lightweight_standalone_library_clean_tpu/
utils/vectors.py`` (pure numpy; the port imports nothing of the JAX
package).  Format layouts reverse-documented from the reference
readers/fixtures:
 - crc_tests.bin        (fields verified against vectors/golden hex dumps)
 - hamming_tests.bin    (16 Hamming(8,4) + 16 Hamming(7,4) roundtrip records)
 - interleaver_tests.bin
 - sync_word_tests.bin
 - detection_tests.bin  (float64 IQ + expected symbols)
 - performance_tests.bin
 - modulation_tests.bin (reader parity with tests/bit_exact_test.cpp:62-105;
   the blob itself is stripped from the reference snapshot)
 - base64 float32 IQ files (tests/base64_utils.hpp consumers)

All little-endian.
"""
from __future__ import annotations

import base64
import struct
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

__all__ = [
    "read_crc_tests", "read_hamming_tests", "read_interleaver_tests",
    "read_sync_word_tests", "read_detection_tests", "read_performance_tests",
    "read_modulation_tests", "read_b64_iq", "write_b64_iq",
]


class _Cursor:
    def __init__(self, data: bytes):
        self.d = data
        self.o = 0

    def u8(self) -> int:
        v = self.d[self.o]
        self.o += 1
        return v

    def u16(self) -> int:
        v, = struct.unpack_from("<H", self.d, self.o)
        self.o += 2
        return v

    def u32(self) -> int:
        v, = struct.unpack_from("<I", self.d, self.o)
        self.o += 4
        return v

    def f64(self) -> float:
        v, = struct.unpack_from("<d", self.d, self.o)
        self.o += 8
        return v

    def bytes(self, n: int) -> bytes:
        v = self.d[self.o:self.o + n]
        self.o += n
        return v

    def array(self, dtype, n: int) -> np.ndarray:
        size = np.dtype(dtype).itemsize * n
        v = np.frombuffer(self.d[self.o:self.o + size], dtype)
        self.o += size
        return v


def read_crc_tests(path) -> list[dict]:
    """{payload, crc, ok} records."""
    c = _Cursor(Path(path).read_bytes())
    out = []
    for _ in range(c.u32()):
        c.u8()  # reserved
        n = c.u32()
        payload = np.frombuffer(c.bytes(n), np.uint8)
        out.append({"payload": payload, "crc": c.u16(), "ok": bool(c.u8())})
    return out


def read_hamming_tests(path) -> list[dict]:
    """Roundtrip records: mode 0 = Hamming(8,4) {in, decoded, expected, err,
    bad}; mode 1 = Hamming(7,4) {in, decoded, expected, err}."""
    c = _Cursor(Path(path).read_bytes())
    out = []
    for _ in range(c.u32()):
        mode = c.u8()
        rec = {"mode": mode, "in": c.u8(), "decoded": c.u8(),
               "expected": c.u8(), "err": bool(c.u8())}
        if mode == 0:
            rec["bad"] = bool(c.u8())
        out.append(rec)
    return out


def read_interleaver_tests(path) -> list[dict]:
    c = _Cursor(Path(path).read_bytes())
    out = []
    for _ in range(c.u32()):
        c.u8()
        ppm = c.u32()
        ncw = c.u32()
        cw = np.frombuffer(c.bytes(ncw), np.uint8)
        nsym = c.u32()
        syms = c.array(np.uint16, nsym)
        deint = np.frombuffer(c.bytes(ncw), np.uint8)
        ok = bool(c.u8())
        out.append({"ppm": ppm, "codewords": cw, "symbols": syms,
                    "deinterleaved": deint, "ok": ok})
    return out


def read_sync_word_tests(path) -> list[dict]:
    c = _Cursor(Path(path).read_bytes())
    out = []
    for _ in range(c.u32()):
        c.u8()
        out.append({"sf": c.u32(), "sync": c.u8(), "ok": bool(c.u8())})
    return out


def read_detection_tests(path) -> list[dict]:
    """{sf, bw_khz, cr, symbols, iq(complex128)} records."""
    c = _Cursor(Path(path).read_bytes())
    out = []
    for _ in range(c.u32()):
        c.u8()
        sf = c.u32()
        bw = c.u32()
        cr = c.u32()
        nsym = c.u32()
        syms = c.array(np.uint32, nsym)
        nsamp = c.u32()
        pairs = c.array(np.float64, nsamp * 2)
        iq = pairs[0::2] + 1j * pairs[1::2]
        out.append({"sf": sf, "bw_khz": bw, "cr": cr,
                    "symbols": syms.astype(np.int64), "iq": iq})
    return out


def read_performance_tests(path) -> list[dict]:
    c = _Cursor(Path(path).read_bytes())
    out = []
    for _ in range(c.u32()):
        c.u8()
        rec = {"sf": c.u32(), "bw_khz": c.u32(), "n": c.u32(),
               "t0": c.f64(), "t1": c.f64()}
        out.append(rec)
    return out


def read_modulation_tests(path) -> list[dict]:
    """Reader parity with tests/bit_exact_test.cpp:62-105 (fields stored
    shifted left by 8; float64 IQ pairs)."""
    c = _Cursor(Path(path).read_bytes())
    out = []
    for _ in range(c.u32()):
        sf = c.u32() >> 8
        bw_khz = c.u32() >> 8
        cr = c.u32() >> 8
        flags = c.u32() >> 8
        n = c.u32() >> 8
        c.u8()
        payload = np.frombuffer(c.bytes(n), np.uint8)
        nsamp = c.u32()
        pairs = c.array(np.float64, nsamp * 2)
        out.append({"sf": sf, "bw_khz": bw_khz, "cr": cr, "flags": flags,
                    "payload": payload,
                    "iq": (pairs[0::2] + 1j * pairs[1::2])})
    return out


def read_b64_iq(path) -> np.ndarray:
    """Base64-encoded float32 interleaved I/Q -> complex64 array."""
    raw = base64.b64decode(Path(path).read_text())
    # tolerate truncated fixtures (the reference's sync_word_iq.b64 is cut
    # mid-sample, SURVEY §4.4.3): drop any partial trailing I/Q pair
    raw = raw[: len(raw) - (len(raw) % 8)]
    f = np.frombuffer(raw, np.float32)
    # truncated fixtures can also carry non-finite garbage in the cut
    # region; assemble under errstate so reading them never warns
    with np.errstate(invalid="ignore", over="ignore"):
        return (f[0::2] + 1j * f[1::2]).astype(np.complex64)


def write_b64_iq(path, iq) -> None:
    iq = np.asarray(iq, np.complex64)
    inter = np.empty(iq.size * 2, np.float32)
    inter[0::2] = iq.real
    inter[1::2] = iq.imag
    Path(path).write_text(base64.b64encode(inter.tobytes()).decode())

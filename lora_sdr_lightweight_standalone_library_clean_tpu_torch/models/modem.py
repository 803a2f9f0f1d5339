"""LoRa modem pipeline: encode/modulate/estimate/compensate/demodulate/decode.

PyTorch port of ``lora_sdr_lightweight_standalone_library_clean_tpu/models/
modem.py`` (reference ``src/phy/phy.cpp``, ``include/lora_phy/phy.hpp``).
Every function is a plain function on tensors, batched over leading axes
(packets), with metrics returned as tensors.  IQ is carried as two float32
planes (re, im) at every public function, as in the JAX package.

The device of the input decides the path.  On a CPU tensor ``modulate``,
``modulate_dechirped``, ``demodulate`` and ``demodulate_wide`` run the plain
PyTorch versions; on a CUDA tensor they launch the hand-written TX kernels
(``ops/cuda_tx.py``) and RX kernels (``ops/cuda_rx.py``) wherever the JAX
package runs a kernel on the TPU, osr > 1 and the wide receiver included.
Host data (numpy arrays, lists) runs on the card; a CPU tensor or
``device="cpu"`` asks for the CPU (``utils/tensors.py::host_device``).  The
codec, the CFO/timing estimator, ``compensate_offsets`` and ``dechirp`` are
plain tensor code on either device, as they are plain XLA code in the JAX
package.

Symbols are int32 tensors (the JAX package's uint16 values; torch's uint16
type supports too few operations on CUDA), decoded bytes uint8, CRCs int32.

Reference parity map:
 - ``encode``             -> phy.cpp:58-66  + LoRaEncoder.cpp:6-18
 - ``decode``             -> phy.cpp:245-261 + LoRaDecoder.cpp:7-21
 - ``modulate``           -> phy.cpp:68-79  + LoRaMod.cpp:8-43
 - ``estimate_offsets``   -> phy.cpp:81-148
 - ``compensate_offsets`` -> phy.cpp:150-180
 - ``demodulate``         -> phy.cpp:182-243
 - ``demodulate_wide``    -> the injective BW-250/500 receiver the
                             reference lacks (JAX models/modem.py:539-722)
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..ops import codes
from ..ops.chirp import _with_sync_prelude, downchirp_ri, modulate_ri
from ..ops.cuda_rx import rx_window_detect
from ..ops.detect import detect_ri
from ..utils.config import LoraParams, Window
from ..utils.errors import InvalidArgumentError, RangeError
from ..utils.tensors import device_table, host_device, int_tensor

__all__ = [
    "DemodResult", "OffsetEstimate",
    "encode", "decode", "crc_sx1272",
    "modulate", "modulate_dechirped", "estimate_offsets",
    "compensate_offsets", "demodulate", "demodulate_wide",
    "window_table", "to_complex", "from_complex", "dechirp",
]

TWO_PI = np.float32(2.0 * np.pi)
PI_F = np.float32(np.pi)


class OffsetEstimate(NamedTuple):
    cfo: torch.Tensor          # carrier frequency offset (fraction of bin/N)
    time_offset: torch.Tensor  # timing offset in oversampled samples


class DemodResult(NamedTuple):
    symbols: torch.Tensor      # (..., S) detected data symbols, int32
    sync_word: torch.Tensor    # (...,) recovered sync byte, uint8
    cfo: torch.Tensor
    time_offset: torch.Tensor
    power: torch.Tensor        # (..., S+2) per-symbol fundamental power dB
    power_avg: torch.Tensor    # (..., S+2) per-symbol noise floor dB


# ---------------------------------------------------------------------------
# Codec  (LoRaEncoder.cpp / LoRaDecoder.cpp / phy.cpp:245-261)
# ---------------------------------------------------------------------------

def encode(payload, params: LoraParams | None = None):
    """Bytes -> Hamming(8,4) symbols, one codeword per nibble
    (LoRaEncoder.cpp:6-18).  Batched over leading axes; int32 out."""
    del params  # sf/cr unused, mirroring LoRaEncoder.cpp:7
    p = int_tensor(payload, torch.int32)
    hi = _ham84_encode(p >> 4)
    lo = _ham84_encode(p & 0xF)
    sym = torch.stack([hi, lo], dim=-1)
    return sym.reshape(p.shape[:-1] + (p.shape[-1] * 2,))


def _ham84_encode(nib):
    """Arithmetic SX Hamming(8,4) encode (LoRaCodes.hpp:229-242): the four
    parity equations as elementwise bit ops."""
    d0 = nib & 1
    d1 = (nib >> 1) & 1
    d2 = (nib >> 2) & 1
    d3 = (nib >> 3) & 1
    return ((nib & 0xF)
            | ((d0 ^ d1 ^ d2) << 4)
            | ((d1 ^ d2 ^ d3) << 5)
            | ((d0 ^ d1 ^ d3) << 6)
            | ((d0 ^ d2 ^ d3) << 7))


def _ham84_decode(c):
    """Arithmetic SX Hamming(8,4) decode with single-bit correction
    (LoRaCodes.hpp:250-281): syndrome + the four correctable-flip selects
    as elementwise bit ops."""
    b0 = c & 1
    b1 = (c >> 1) & 1
    b2 = (c >> 2) & 1
    b3 = (c >> 3) & 1
    p0 = b0 ^ b1 ^ b2 ^ ((c >> 4) & 1)
    p1 = b1 ^ b2 ^ b3 ^ ((c >> 5) & 1)
    p2 = b0 ^ b1 ^ b3 ^ ((c >> 6) & 1)
    p3 = b0 ^ b2 ^ b3 ^ ((c >> 7) & 1)
    parity = p0 | (p1 << 1) | (p2 << 2) | (p3 << 3)
    flip = ((parity == 0xD).to(c.dtype)
            | ((parity == 0x7).to(c.dtype) << 1)
            | ((parity == 0xB).to(c.dtype) << 2)
            | ((parity == 0xE).to(c.dtype) << 3))
    return (c ^ flip) & 0xF


@functools.lru_cache(maxsize=None)
def _crc_position_tables(n: int) -> np.ndarray:
    """S[k][b] = the CCITT step map applied k times to byte value b.

    The SX1272 CRC step is GF(2)-linear in (state, byte): byte i of an
    n-byte message enters the register and then undergoes n-1-i further
    step applications, so the final CRC is the XOR of per-position table
    lookups (LoRaCodes.hpp:92-105 semantics, summed in parallel).  Returns
    (n, 256) uint16 with S[k] = step^k.
    """
    tab = codes.crc16_table()
    s = np.zeros((max(n, 1), 256), np.uint16)
    s[0] = np.arange(256, dtype=np.uint16)
    for k in range(1, n):
        prev = s[k - 1]
        s[k] = (((prev.astype(np.uint32) << 8) & 0xFFFF)
                ^ tab[prev >> 8]).astype(np.uint16)
    return s


def _xor_reduce_last(x):
    """XOR-reduce the last axis with a log-depth fold, as the JAX package
    does (used by the dynamic-length frame CRC, ``models/frame.py::
    crc_sx1272_at``).  An empty axis reduces to 0."""
    if x.shape[-1] == 0:
        return torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    while x.shape[-1] > 1:
        half = x.shape[-1] // 2
        folded = x[..., :half] ^ x[..., half:2 * half]
        x = folded if x.shape[-1] % 2 == 0 else torch.cat(
            [folded, x[..., 2 * half:]], dim=-1)
    return x[..., 0]


@functools.lru_cache(maxsize=None)
def _crc_bit_matrix(n: int) -> np.ndarray:
    """(n*8, 16) GF(2) generator matrix of the n-byte SX1272 CRC.

    Row ``k*8 + i`` holds the 16 CRC bits contributed by bit i of message
    byte k, i.e. ``step^{n-1-k}(1 << i)`` — the step map is GF(2)-linear
    in the state (LoRaCodes.hpp:69-79), so the whole CRC is one GF(2)
    matrix-vector product.  float32 for the matmul."""
    s = _crc_position_tables(n)                       # (n, 256)
    rows = np.zeros((n * 8, 16), np.float32)
    j = np.arange(16)
    for k in range(n):
        for i in range(8):
            rows[k * 8 + i] = (int(s[n - 1 - k][1 << i]) >> j) & 1
    return rows


def _bit_weights() -> np.ndarray:
    return (1 << np.arange(16, dtype=np.int32)).astype(np.int32)


def crc_sx1272(data, length: int | None = None):
    """Batched SX1272 CRC-16 over the last axis (LoRaCodes.hpp:92-105).

    GF(2)-linearity turns the reference's per-byte loop into one float32
    matmul: message bits (..., n*8) x generator matrix (n*8, 16), reduced
    mod 2.  Counts stay < 2^24, so float32 is exact (on the card only in
    full float32, never TF32).  The length-dependent LFSR mask bytes are
    host constants (codes.crc_mask_pair).  Returns int32 values < 2^16.
    """
    d = int_tensor(data, torch.int32)
    n = d.shape[-1] if length is None else length
    m0, m1 = codes.crc_mask_pair(n)
    if n == 0:
        return torch.full(d.shape[:-1], m0 ^ (m1 << 8), dtype=torch.int32,
                          device=d.device)
    shifts = torch.arange(8, dtype=torch.int32, device=d.device)
    bits = (d[..., :n, None] >> shifts) & 1
    bits = bits.reshape(d.shape[:-1] + (n * 8,)).to(torch.float32)
    m = device_table(_crc_bit_matrix, n, device=d.device)
    acc = torch.matmul(bits, m)
    crc_bits = acc.to(torch.int32) & 1                       # (..., 16)
    weights = device_table(_bit_weights, device=d.device)
    res = torch.sum(crc_bits * weights, dim=-1, dtype=torch.int32)
    return res ^ (m0 ^ (m1 << 8))


def decode(symbols, params: LoraParams | None = None, *,
           check_crc: bool = True):
    """Symbol pairs -> bytes via Hamming(8,4) decode, plus CRC verdict
    (LoRaDecoder.cpp:7-21, phy.cpp:245-261).

    Returns ``(payload, crc_ok)``: uint8 bytes and a bool tensor over the
    batch axes (False when fewer than 4 bytes decode, phy.cpp:257-258).
    """
    del params
    s = int_tensor(symbols, torch.int32)
    if s.shape[-1] % 2 != 0:
        raise InvalidArgumentError(
            f"symbol count must be even, got {s.shape[-1]}")
    nib = _ham84_decode(s & 0xFF)
    hi = nib[..., 0::2] & 0xF
    lo = nib[..., 1::2] & 0xF
    payload = ((hi << 4) | lo).to(torch.uint8)
    k = payload.shape[-1]
    if not check_crc:
        return payload, torch.zeros(payload.shape[:-1], dtype=torch.bool,
                                    device=payload.device)
    if k >= 4:
        provided = (payload[..., k - 2].to(torch.int32)
                    | (payload[..., k - 1].to(torch.int32) << 8))
        calc = crc_sx1272(payload[..., 2:k - 2])
        crc_ok = provided == calc
    else:
        crc_ok = torch.zeros(payload.shape[:-1], dtype=torch.bool,
                             device=payload.device)
    return payload, crc_ok


# ---------------------------------------------------------------------------
# Modulation  (phy.cpp:68-79)
# ---------------------------------------------------------------------------

def modulate(symbols, params: LoraParams, amplitude: float = 1.0):
    """Symbols -> IQ planes; sync prelude + phase-continuous up-chirps.

    Returns (re, im) float32 of shape (..., (S+2) * step).  A CUDA input
    runs the TX kernel (``dechirp=False``), a CPU input the plain forms
    (``ops/chirp.py::modulate_ri``).
    """
    return modulate_ri(symbols, params, amplitude)


def modulate_dechirped(symbols, params: LoraParams, amplitude: float = 1.0):
    """Modulate and dechirp in one pass: the producer chain of the
    golden-vector / perf pipeline (modulate -> external dechirp,
    tests/e2e_chain_test.cpp:79-93, tests/performance_test.cpp:112-125).

    Equivalent to ``dechirp(*modulate(...))`` up to last-ULP IQ
    differences.  Where a TX kernel covers the configuration
    (``ops/cuda_tx.py::tx_supported``: osr == 1 to sf12; osr > 1 with tone
    modulus 128 <= n*osr/bw_scale <= 4096, both wide profiles included) the
    down-chirp multiply folds into the TX multiplier, so the pre-dechirped
    stream is written once: a CUDA input launches the kernel, a CPU input
    runs its plain version.  Elsewhere both devices modulate in closed form
    then dechirp, the JAX package's own dispatch (``models/modem.py:
    247-252``).
    """
    from ..ops.cuda_tx import tx_supported, tx_tone_synth
    sym = int_tensor(symbols, torch.int32)
    if tx_supported(params.n, params.osr, params.bw_scale):
        allsyms = _with_sync_prelude(sym, params)
        return tx_tone_synth(allsyms, params, amplitude, dechirp=True)
    return dechirp(*modulate(sym, params, amplitude), params)


# ---------------------------------------------------------------------------
# Window tables  (phy.cpp:39-50)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def window_table(n: int, kind: Window) -> np.ndarray | None:
    if kind == Window.NONE:
        return None
    i = np.arange(n, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * i / (n - 1.0))).astype(np.float32)


# ---------------------------------------------------------------------------
# Offset estimation  (phy.cpp:81-148 / LoRaDemod.cpp:80-136)
# ---------------------------------------------------------------------------

def _wrap_pi(d):
    """Wrap a phase delta into [-pi, pi] (phy.cpp:128-131)."""
    d = torch.where(d > float(PI_F), d - float(TWO_PI), d)
    return torch.where(d < -float(PI_F), d + float(TWO_PI), d)


def _best_over_osr(det, osr: int, tie_break_idx: bool):
    """Sequentially select the best oversampling phase t per symbol.

    Mirrors the exact comparison chain: strictly-greater power
    (phy.cpp:116-123) or, for the legacy path, equal-power lowest-index
    (LoRaDemod.cpp:102-111).  ``det`` fields have shape (..., osr).
    """
    shape = det.power.shape[:-1]
    dev = det.power.device
    best_p = torch.full(shape, -1e30, dtype=torch.float32, device=dev)
    best_idx = torch.zeros(shape, dtype=torch.int32, device=dev)
    best_f = torch.zeros(shape, dtype=torch.float32, device=dev)
    best_t = torch.zeros(shape, dtype=torch.int32, device=dev)
    best_br = torch.zeros(shape, dtype=torch.float32, device=dev)
    best_bi = torch.zeros(shape, dtype=torch.float32, device=dev)
    for t in range(osr):
        p = det.power[..., t]
        idx = det.index[..., t]
        better = p > best_p
        if tie_break_idx:
            better = better | ((p == best_p) & (idx < best_idx))
        best_idx = torch.where(better, idx, best_idx)
        best_f = torch.where(better, det.findex[..., t], best_f)
        best_t = torch.where(better, torch.full_like(best_t, t), best_t)
        best_br = torch.where(better, det.bin_re[..., t], best_br)
        best_bi = torch.where(better, det.bin_im[..., t], best_bi)
        best_p = torch.where(better, p, best_p)
    return best_p, best_idx, best_f, best_t, best_br, best_bi


def _estimate_core(iq_r, iq_i, params: LoraParams, est_syms: int,
                   tie_break_idx: bool) -> OffsetEstimate:
    """Shared CFO/timing estimator over the first ``est_syms`` symbols.

    Per symbol, every oversampling phase is windowed and detected; the best
    phase's (index + fractional index) average gives the coarse CFO, the
    wrapped inter-symbol phase delta of the winning bin gives the fine CFO,
    and the average winning phase minus the fractional part gives the timing
    offset (phy.cpp:100-147).  Its DFT is a plain ``torch.matmul``
    (``ops/dft.py``), as it is plain XLA in the JAX package.
    """
    n, osr, step = params.n, params.osr, params.step
    sym = iq_r[..., : est_syms * step].reshape(
        iq_r.shape[:-1] + (est_syms, n, osr))
    symi = iq_i[..., : est_syms * step].reshape(
        iq_i.shape[:-1] + (est_syms, n, osr))
    # axes (..., s, i, t) -> (..., s, t, i)
    zr = torch.movedim(sym, -1, -2)
    zi = torch.movedim(symi, -1, -2)
    win = window_table(n, params.window)
    if win is not None:
        w = device_table(window_table, n, params.window, device=zr.device)
        zr = zr * w
        zi = zi * w
    det = detect_ri(zr, zi)
    best_p, best_idx, best_f, best_t, best_br, best_bi = _best_over_osr(
        det, osr, tie_break_idx)

    sum_index = torch.sum(best_idx.to(torch.float32) + best_f, dim=-1)
    sum_t = torch.sum(best_t, dim=-1)
    phase = torch.atan2(best_bi, best_br)                      # std::arg
    if est_syms > 1:
        deltas = _wrap_pi(phase[..., 1:] - phase[..., :-1])
        phase_diff = torch.sum(deltas, dim=-1)
        cfo_fine = ((phase_diff / float(np.float32(est_syms - 1)))
                    / float(TWO_PI * n))
    else:
        cfo_fine = torch.zeros_like(sum_index)
    avg_index = sum_index / float(np.float32(est_syms))
    cfo = avg_index / float(np.float32(n)) + cfo_fine
    frac = avg_index - torch.floor(avg_index + 0.5)
    avg_t = sum_t.to(torch.float32) / float(np.float32(est_syms))
    time_offset = avg_t - frac * float(np.float32(n)) * float(np.float32(osr))
    return OffsetEstimate(cfo, time_offset)


def estimate_offsets(iq_r, iq_i, params: LoraParams) -> OffsetEstimate:
    """Estimate CFO and timing offset from preamble symbols (phy.cpp:81-148).

    Uses every whole symbol present in the input, matching the reference's
    symbol loop.  Batched over leading axes.
    """
    symbols = iq_r.shape[-1] // params.step
    if symbols == 0:
        raise InvalidArgumentError("need at least one whole symbol")
    return _estimate_core(iq_r, iq_i, params, symbols, tie_break_idx=False)


def compensate_offsets(iq_r, iq_i, params: LoraParams, est: OffsetEstimate):
    """Derotate by -CFO then integer-shift by the timing offset with
    zero-fill (phy.cpp:150-180).  Batched; returns new (re, im).

    A shift of |off| >= the sample count leaves the derotated stream
    unshifted, as in the JAX package.
    """
    n, osr = params.n, params.osr
    count = iq_r.shape[-1]
    dev = iq_r.device
    rate = -float(TWO_PI) * est.cfo / float(np.float32(n * osr))   # (...,)
    ph = rate[..., None] * torch.arange(count, dtype=torch.float32,
                                        device=dev)
    c, s = torch.cos(ph), torch.sin(ph)
    rr = iq_r * c - iq_i * s
    ri = iq_r * s + iq_i * c
    off = torch.round(est.time_offset).to(torch.int64)[..., None]  # (..., 1)
    # shift right by off (> 0) with leading zeros, left by -off with
    # trailing zeros
    src = torch.arange(count, device=dev) - off
    do_shift = (off != 0) & (off.abs() < count)
    in_bounds = (src >= 0) & (src < count)
    src_c = torch.clamp(src, 0, count - 1).expand(rr.shape)
    shifted_r = torch.where(in_bounds, torch.gather(rr, -1, src_c), 0.0)
    shifted_i = torch.where(in_bounds, torch.gather(ri, -1, src_c), 0.0)
    return (torch.where(do_shift, shifted_r, rr),
            torch.where(do_shift, shifted_i, ri))


# ---------------------------------------------------------------------------
# Full-RX demodulation  (phy.cpp:182-243)
# ---------------------------------------------------------------------------

def _full_rx_mult(sf: int, bw_scale: int, window: Window):
    """The full-RX multiplier: the demod down-chirp x window (phy.cpp:
    206-227), as the JAX package's kernel branch folds it
    (``models/modem.py:497-501``)."""
    dcr, dci = downchirp_ri(sf, bw_scale)
    win = window_table(1 << sf, window)
    if win is not None:
        dcr = dcr * win
        dci = dci * win
    return dcr, dci


def demodulate(iq_r, iq_i, params: LoraParams,
               symbol_cap: int | None = None,
               backend: str = "auto") -> DemodResult:
    """Full-fidelity RX: offset estimation, dechirp, CFO derotation,
    windowing, detection, sync-word extraction (phy.cpp:182-243).

    ``iq`` length must be a whole number of oversampled symbols and contain
    at least the two sync symbols; the first two detections become the sync
    word, the rest the data symbols.  The estimator runs on the raw sync
    chirps without the tones path's tie-break (phy.cpp:81-148), so on the
    reference's own modulation it returns the reference's offset estimate,
    not the true one (PARITY.md defect 1).

    The device of the input decides the detection path
    (``ops/cuda_rx.py::rx_window_detect``): a CUDA tensor runs the fused RX
    kernel (``rx_dense``/``rx_hybrid`` at osr == 1, ``rx_osr`` on the
    decimated osr > 1 windows), a CPU tensor its plain version.  Both rotate
    each window and then multiply
    by down-chirp x window, as the JAX package's kernel branch does; its jnp
    branch dechirps before it rotates (``models/modem.py:515-525``), a float
    reordering that moves no detection of the reference fixtures.

    ``backend`` takes the JAX package's values: ``"auto"`` and
    ``"pallas_rx"`` are the fused RX route above; ``"pallas"`` is the
    two-stage route (``modem.py:506-525``): timing-shifted windows, the
    down-chirp, then ``models/tones.py::_rotate_detect`` (the window, then
    the rotate-detect kernel on a CUDA tensor, n <= 512; its plain version
    on a CPU tensor).
    """
    from .tones import _rotate_detect, _rotation_start, _two_stage
    two_stage = _two_stage(backend)
    n, osr, step = params.n, params.osr, params.step
    sample_count = iq_r.shape[-1]
    if sample_count % step != 0:
        raise InvalidArgumentError(
            f"sample count {sample_count} not a multiple of step {step}")
    total = sample_count // step
    if total < 2:
        raise RangeError("input must contain at least two symbols")
    num_symbols = total - 2
    if symbol_cap is not None and num_symbols > symbol_cap:
        raise RangeError(f"{num_symbols} symbols exceed cap {symbol_cap}")

    est = _estimate_core(iq_r, iq_i, params, 2, tie_break_idx=False)
    t_off = torch.round(est.time_offset).to(torch.int32)
    rate = -float(TWO_PI) * est.cfo / float(np.float32(n))
    if two_stage:
        zr, zi = _timing_shifted_windows(iq_r, iq_i, t_off, total, step,
                                         osr, n)
        dcr, dci = device_table(downchirp_ri, params.sf, params.bw_scale,
                                device=iq_r.device)
        ar = zr * dcr - zi * dci
        ai = zr * dci + zi * dcr
        idx, power, power_avg = _rotate_detect(
            ar, ai, rate, _rotation_start(rate, t_off, total, params),
            params)
    else:
        mr, mi = device_table(_full_rx_mult, params.sf, params.bw_scale,
                              params.window, device=iq_r.device)
        idx, power, power_avg = rx_window_detect(
            iq_r.contiguous(), iq_i.contiguous(),
            torch.clamp(t_off, -step, step), rate, torch.ones_like(rate),
            mr, mi, params)
    sw0, sw1 = idx[..., 0], idx[..., 1]
    shift = params.sf - 4 if params.sf > 4 else 0
    sync = (((sw0 >> shift) & 0xF) << 4) | ((sw1 >> shift) & 0xF)
    return DemodResult(
        symbols=idx[..., 2:],
        sync_word=sync.to(torch.uint8),
        cfo=est.cfo,
        time_offset=est.time_offset,
        power=power,
        power_avg=power_avg,
    )


def _timing_shifted_windows(iq_r, iq_i, t_off, total: int, step: int,
                            osr: int, n: int, decimate: bool = True):
    """Extract per-symbol windows with the reference's per-symbol
    timing-shift clamps (phy.cpp:209-216).

    Each packet's stream is shifted by its ``t_off`` (clipped to
    [-step, step], zero-padded by one step on each side) with one gather;
    with |t_off| <= step the per-symbol clamp can only fall back to the
    unshifted base at the edges — symbol 0 when t < 0 and symbol S-1 when
    t > 0 — so just those rows are patched from the unshifted stream.
    """
    sample_count = total * step
    batched = iq_r.ndim > 1
    t = t_off if batched else t_off[None]
    r2 = iq_r if batched else iq_r[None]
    i2 = iq_i if batched else iq_i[None]
    lead = r2.shape[:-1]
    dev = r2.device

    tc = torch.clamp(t.to(torch.int64), -step, step).reshape(-1, 1)
    pad_r = torch.nn.functional.pad(
        r2[..., :sample_count].reshape(-1, sample_count), (step, step))
    pad_i = torch.nn.functional.pad(
        i2[..., :sample_count].reshape(-1, sample_count), (step, step))
    src = step + tc + torch.arange(sample_count, device=dev)
    wr = torch.gather(pad_r, 1, src).reshape(lead + (total, step))
    wi = torch.gather(pad_i, 1, src).reshape(lead + (total, step))

    tb = t[..., None]                                           # (..., 1)
    use_un_first = tb < 0
    use_un_last = tb > 0
    wr[..., 0, :] = torch.where(use_un_first, r2[..., :step], wr[..., 0, :])
    wi[..., 0, :] = torch.where(use_un_first, i2[..., :step], wi[..., 0, :])
    last = (total - 1) * step
    wr[..., total - 1, :] = torch.where(
        use_un_last, r2[..., last:last + step], wr[..., total - 1, :])
    wi[..., total - 1, :] = torch.where(
        use_un_last, i2[..., last:last + step], wi[..., total - 1, :])
    if decimate:
        # decimate: sample i*osr within each window
        wr = wr.reshape(lead + (total, n, osr))[..., 0]
        wi = wi.reshape(lead + (total, n, osr))[..., 0]
    if not batched:
        wr, wi = wr[0], wi[0]
    return wr, wi


def _wide_mult(n: int, osr: int, window: Window):
    """The wide detection's multiplier: the reference's decimated-grid
    window repeated per oversampled sample (or ones), and zeros
    (``models/modem.py:635-638`` of the JAX package)."""
    win = window_table(n, window)
    w = (np.repeat(win, osr) if win is not None
         else np.ones(n * osr, np.float32))
    return w, np.zeros(n * osr, np.float32)


def _signed_mod(x, m: int):
    r = torch.remainder(x, m)
    return torch.where(r > m // 2, r - m, r)


def demodulate_wide(iq_r, iq_i, params: LoraParams,
                    normalize: bool = True,
                    backend: str = "auto") -> DemodResult:
    """Injective oversampled demodulation: the BW-250/500 receiver the
    reference cannot express (the JAX package's ``models/modem.py:
    539-722``).

    The reference detector decimates each window to N samples and takes an
    N-bin FFT, so its symbol->bin map is ``sym * bw_scale mod N``: at
    bw_scale > 1 the top log2(bw_scale) bits of every symbol are lost.  The
    waveform is injective whenever osr >= bw_scale: this receiver keeps the
    full oversampled window and detects over an (N*osr)-point DFT, where the
    tone lands at wide bin ``sym * bw_scale``.

    Input is pre-dechirped at full rate (the ``dechirp`` helper's output),
    like ``demodulate_tones``: peak normalization into [-1, 1], the
    2-symbol CFO/timing estimate with the lowest-index tie-break, the CFO
    rate -2*pi*cfo/(N*osr) per full-rate sample, then one
    ``rx_window_detect(wide=True)`` over every symbol with the window
    repeated per oversampled sample.  The two sync chirps are known
    pilots: their common wide-bin offset is measured and subtracted before
    the bins snap to the symbol grid.  Requires osr >= bw_scale.

    The JAX package cuts the symbols into chunks with one-row halos so a
    call fits the TPU's VMEM (``wide_supported``); its chunked and one-call
    paths give the same detections, and on the card a window is one block
    reading device memory, so one call covers all symbols.  A CUDA input
    runs ``rx_dense``/``rx_hybrid`` at n*osr points, a CPU input the plain
    version.

    ``backend`` takes the JAX package's kernel values: ``"auto"`` and
    ``"pallas_rx"`` both run the fused RX above (the device of the input
    decides kernel or plain version); any other value raises, as
    ``models/tones.py::_two_stage`` does for a value it does not know (the
    wide receiver has no two-stage route, and a CPU tensor is the plain
    route, so there is no ``"jnp"``).

    Returns a DemodResult; ``symbols`` are recovered symbol values (divided
    out of the wide-bin grid), ``power``/``power_avg`` per symbol in dB.
    """
    if backend not in ("auto", "pallas_rx"):
        raise InvalidArgumentError(
            f"backend {backend!r}: the wide receiver's routes are 'auto' and "
            "'pallas_rx' (the fused RX kernel); a CPU tensor runs its plain "
            "version, so there is no 'jnp' route")
    n, osr, step = params.n, params.osr, params.step
    bs = params.bw_scale
    if osr < bs:
        raise InvalidArgumentError(
            f"wide demodulation needs osr >= bw_scale ({osr} < {bs})")
    sample_count = iq_r.shape[-1]
    if sample_count % step != 0:
        raise InvalidArgumentError(
            f"sample count {sample_count} not a multiple of step {step}")
    total = sample_count // step
    if total < 2:
        raise RangeError("input must contain at least two symbols")
    iq_r = iq_r.contiguous()
    iq_i = iq_i.contiguous()

    if normalize:
        inf = float("inf")
        max_amp = torch.maximum(
            torch.linalg.vector_norm(iq_r, ord=inf, dim=-1),
            torch.linalg.vector_norm(iq_i, ord=inf, dim=-1))
        scale = torch.where(max_amp > 1.0, 1.0 / max_amp,
                            torch.ones_like(max_amp))[..., None]
    else:
        scale = torch.ones(iq_r.shape[:-1] + (1,), dtype=torch.float32,
                           device=iq_r.device)

    est = _estimate_core(iq_r[..., : 2 * step] * scale,
                         iq_i[..., : 2 * step] * scale,
                         params, 2, tie_break_idx=True)
    t_off = torch.round(est.time_offset).to(torch.int32)
    # the decimated-grid rate (-2*pi*cfo/n per decimated sample) spread
    # over osr full-rate samples
    rate = -float(TWO_PI) * est.cfo / float(np.float32(n * osr))
    mr, mi = device_table(_wide_mult, n, osr, params.window,
                          device=iq_r.device)
    idx, power, power_avg = rx_window_detect(
        iq_r, iq_i, torch.clamp(t_off, -step, step), rate,
        scale[..., 0].contiguous(), mr, mi, params, wide=True)

    # residual timing/CFO moves every tone by the same wide-bin offset:
    # measure it on the sync pilots and subtract it before snapping
    exp0, exp1 = params.sync_nibble_symbols()
    d0 = _signed_mod(idx[..., 0] - exp0 * bs, step).to(torch.float32)
    d1 = _signed_mod(idx[..., 1] - exp1 * bs, step).to(torch.float32)
    delta = (d0 + d1) * 0.5
    shifted = _signed_mod(idx - torch.round(delta[..., None]).to(torch.int32),
                          step)
    corrected = torch.round(shifted.to(torch.float32)
                            / float(np.float32(bs))).to(torch.int32)
    sym_wide = torch.remainder(corrected, n)
    sw0, sw1 = sym_wide[..., 0], sym_wide[..., 1]
    shift = params.sf - 4 if params.sf > 4 else 0
    sync = (((sw0 >> shift) & 0xF) << 4) | ((sw1 >> shift) & 0xF)
    return DemodResult(
        symbols=sym_wide[..., 2:],
        sync_word=sync.to(torch.uint8),
        cfo=est.cfo,
        time_offset=est.time_offset,
        power=power,
        power_avg=power_avg,
    )


# ---------------------------------------------------------------------------
# Host-boundary helpers
# ---------------------------------------------------------------------------

def to_complex(re, im) -> np.ndarray:
    """Assemble host complex64 IQ from device planes."""
    re = re.detach().cpu().numpy() if isinstance(re, torch.Tensor) else re
    im = im.detach().cpu().numpy() if isinstance(im, torch.Tensor) else im
    return (np.asarray(re).astype(np.float32)
            + 1j * np.asarray(im).astype(np.float32))


def from_complex(iq, device="cuda") -> tuple[torch.Tensor, torch.Tensor]:
    """Split host complex IQ into float32 planes on ``device``: the CUDA
    card unless the caller asks for the CPU (``device="cpu"``); without a
    card the default raises (``utils/tensors.py::host_device``)."""
    dev = host_device(device)
    iq = np.asarray(iq)
    return (torch.as_tensor(iq.real.astype(np.float32), device=dev),
            torch.as_tensor(iq.imag.astype(np.float32), device=dev))


def _tiled_downchirp(sf: int, bw_scale: int, osr: int, total: int):
    dcr, dci = downchirp_ri(sf, bw_scale, osr)
    return np.tile(dcr, total), np.tile(dci, total)


def dechirp(iq_r, iq_i, params: LoraParams):
    """Multiply each symbol window by the base down-chirp — the external
    dechirp step of the golden-vector path (tests/e2e_chain_test.cpp:79-93)."""
    step = params.step
    total = iq_r.shape[-1] // step
    dcr, dci = device_table(_tiled_downchirp, params.sf, params.bw_scale,
                            params.osr, total, device=iq_r.device)
    cut = total * step
    rr = iq_r[..., :cut] * dcr - iq_i[..., :cut] * dci
    ri = iq_r[..., :cut] * dci + iq_i[..., :cut] * dcr
    return rr, ri

"""BER/PER-vs-SNR sweep harness.

PyTorch port of ``lora_sdr_lightweight_standalone_library_clean_tpu/models/
sweep.py``.  Every packet of an SNR point runs as one batch on the card:
encode -> modulate -> dechirp (noise-free, once) -> AWGN -> demodulate ->
decode -> error rates.  ``per_sweep`` draws its payloads from
``np.random.default_rng(seed)``, as the JAX package does, and its noise from
a ``torch.Generator`` seeded with ``seed`` on the device (torch cannot
reproduce ``jax.random``'s draws, so the two packages' sweeps agree
statistically, not draw for draw).  ``_sweep_metrics`` is the part after
the channel, so the parity tests can feed it the JAX package's own noisy
planes.

``ser_theory``, ``snr_at_ser_theory`` and ``snr_at_level`` are numpy, the
JAX package's own code: the exact SER of the ideal non-coherent LoRa
detector is the anchor the measured waterfall must track.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import channel
from ..utils.config import LoraParams
from ..utils.tensors import host_device
from .modem import decode, dechirp, demodulate_wide, encode, modulate
from .tones import demodulate_tones

__all__ = ["SweepPoint", "per_sweep", "ser_theory", "snr_at_ser_theory",
           "snr_at_level"]

# numpy 2 names the trapezoid rule ``trapezoid``; numpy 1 ``trapz``
_trapezoid = getattr(np, "trapezoid", None) or np.trapz


class SweepPoint(NamedTuple):
    snr_db: float
    ser: float        # symbol error rate
    ber: float        # payload bit error rate
    per: float        # packet error rate (any payload byte wrong)
    crc_ok_rate: float


# ---------------------------------------------------------------------------
# Analytic anchor: LoRa symbol detection over AWGN is non-coherent M-ary
# orthogonal signalling (dechirp -> N-bin DFT -> power argmax) with M = 2^sf
# and per-bin SNR gamma = N * 10^(snr_db/10) (N samples integrate
# coherently; ops/channel.py::awgn defines snr_db per complex sample at
# unit signal power).  The exact symbol error probability is
#
#   P_s = 1 - int_0^inf e^{-(u+g)} I0(2 sqrt(u g)) (1 - e^{-u})^{M-1} du
#
# evaluated by log-domain quadrature (the alternating binomial series is
# numerically useless at M = 4096).
# ---------------------------------------------------------------------------

def _log_i0(z: np.ndarray) -> np.ndarray:
    """log(I0(z)), stable for large z (np.i0 overflows past ~709)."""
    z = np.asarray(z, np.float64)
    small = z < 700.0
    out = np.empty_like(z)
    out[small] = np.log(np.i0(z[small]))
    zl = z[~small]
    out[~small] = zl - 0.5 * np.log(2.0 * np.pi * zl) + np.log1p(1.0 / (8.0 * zl))
    return out


def ser_theory(snr_db, sf: int):
    """Exact AWGN symbol-error rate of the ideal non-coherent LoRa
    detector at per-sample ``snr_db`` (scalar or array)."""
    m = 1 << sf
    snr_db = np.atleast_1d(np.asarray(snr_db, np.float64))
    out = np.empty(snr_db.shape, np.float64)
    for i, s in enumerate(snr_db):
        g = m * 10.0 ** (s / 10.0)
        hi = g + 40.0 * np.sqrt(g + 1.0) + 40.0
        u = np.linspace(1e-12, hi, 20001)
        logf = (-(u + g) + _log_i0(2.0 * np.sqrt(u * g))
                + (m - 1) * np.log1p(-np.exp(-np.minimum(u, 700.0))))
        p_c = _trapezoid(np.exp(logf), u)
        out[i] = min(max(1.0 - p_c, 0.0), 1.0)
    return out if out.size > 1 else float(out[0])


def snr_at_ser_theory(target_ser: float, sf: int,
                      lo: float = -40.0, hi: float = 10.0) -> float:
    """SNR (dB) at which the ideal detector hits ``target_ser`` (bisect)."""
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        if ser_theory(mid, sf) > target_ser:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


def snr_at_level(points: list["SweepPoint"], level: float,
                 field: str = "ser") -> float:
    """Interpolate the SNR at which a measured sweep crosses ``level``
    (log-domain linear interpolation on a descending waterfall)."""
    xs = [p.snr_db for p in points]
    ys = [max(getattr(p, field), 1e-12) for p in points]
    for i in range(len(xs) - 1):
        if ys[i] >= level >= ys[i + 1]:
            f = ((np.log(level) - np.log(ys[i]))
                 / (np.log(ys[i + 1]) - np.log(ys[i])))
            return xs[i] + f * (xs[i + 1] - xs[i])
    raise ValueError(f"sweep does not cross {field}={level}: {ys}")


def _popcount8(x):
    x = x - ((x >> 1) & 0x55)
    x = (x & 0x33) + ((x >> 2) & 0x33)
    return (x + (x >> 4)) & 0x0F


def _sweep_chain(payloads, params: LoraParams):
    """The noise-free part of a point: (symbols, dechirped re, im)."""
    syms = encode(payloads)
    dr, di = dechirp(*modulate(syms, params), params)
    return syms, dr, di


def _sweep_metrics(payloads, syms, dr, di, params: LoraParams,
                   receiver: str = "tones"):
    """Error rates of one point from its noisy dechirped planes: (ser,
    ber, per, crc_ok rate) as float32 tensors on the planes' device."""
    if receiver == "wide":
        # the injective osr >= bw_scale receiver: symbols come back as
        # symbol values, so the comparison is direct
        res = demodulate_wide(dr, di, params)
        expect = syms
    else:
        res = demodulate_tones(dr, di, params)
        # detected bins live in [0, N): compare against (sym*bs) mod N,
        # the modulation's symbol->bin mapping (PARITY.md defect 2)
        expect = (syms * params.bw_scale) % params.n
    dec, crc_ok = decode(res.symbols, check_crc=True)
    pay = payloads.to(torch.int32)
    sym_err = (res.symbols != expect).to(torch.float32).mean()
    bit_err = _popcount8(dec.to(torch.int32) ^ pay).to(
        torch.float32).mean() / 8.0
    pkt_err = (dec.to(torch.int32) != pay).any(dim=-1).to(
        torch.float32).mean()
    return sym_err, bit_err, pkt_err, crc_ok.to(torch.float32).mean()


def per_sweep(params: LoraParams, snrs_db, packets: int = 1000,
              payload_len: int = 16, seed: int = 0,
              receiver: str = "tones", device=None) -> list[SweepPoint]:
    """Run a PER/BER sweep over ``snrs_db`` with ``packets`` random packets
    per point; every packet of a point runs as one batch on ``device`` (the
    CUDA card unless the caller names another, ``utils/tensors.py::
    host_device``).  ``receiver="wide"`` sweeps through ``demodulate_wide``
    (required for decodable BW-250/500 sweeps: the reference-faithful tones
    path cannot round-trip bw_scale > 1)."""
    dev = host_device(device)
    rng = np.random.default_rng(seed)
    payloads = torch.as_tensor(
        rng.integers(0, 256, (packets, payload_len)).astype(np.uint8),
        device=dev)
    syms, dr, di = _sweep_chain(payloads, params)
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = []
    for snr in snrs_db:
        nr, ni = channel.awgn(gen, dr, di, float(snr))
        ser, ber, per, crc = _sweep_metrics(payloads, syms, nr, ni, params,
                                            receiver)
        out.append(SweepPoint(float(snr), float(ser), float(ber),
                              float(per), float(crc)))
    return out

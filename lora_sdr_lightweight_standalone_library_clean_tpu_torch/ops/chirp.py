"""Chirp synthesis: closed-form, integer-exact phase.

PyTorch port of ``lora_sdr_lightweight_standalone_library_clean_tpu/ops/
chirp.py`` (reference ``include/lora_phy/ChirpGenerator.hpp:24-51`` and
``src/phy/LoRaMod.cpp:8-43``).

For up-chirp symbol ``sym`` at sample ``n`` (``m = n+1`` frequency steps
taken), the accumulated phase is exactly::

    phi(m) = pi * bw_scale * num(m) / (N * osr^2)          (mod 2*pi)
    num(m) = -m*N*osr + 2*sym*m*osr + m*(m+1) - 2*W(m)*N*osr

where ``W(m)`` counts the frequency-wrap subtractions (ChirpGenerator.hpp:
36,44) across the first ``m`` steps, with the closed form
``W(m) = S(c+m) - S(c)``, ``S(t) = sum_{j<t} j//b = b*q*(q-1)/2 + q*r``
(``q = t//b``, ``r = t%b``).  Phase continuity across symbols
(LoRaMod.cpp:14) is carried as integer numerators mod ``2*N*osr^2``.  All
integers here are int64, so every numerator is exact.

Two plain forms synthesize the IQ, as in the JAX package:

* ``_modulate_ri_vpu``: the closed-form phases plus one sin/cos per sample
  (any osr);
* ``_modulate_ri_mxu`` (osr == 1): ``chirp_s[m] = sign_k * base[m] *
  w^(t*m)`` with ``t = (s*bs) mod n``, the tone factor a row lookup in the
  (n, n) tone table.

``modulate_ri`` lets the device of its input decide: a CUDA tensor goes to
the hand-written TX kernels (``ops/cuda_tx.py``) where they cover the
configuration, a CPU tensor to the plain forms.  Valid for ``sym < 2*N``,
like the reference's single-subtraction wrap.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..utils.config import LoraParams
from ..utils.errors import InvalidArgumentError
from ..utils.tensors import device_table, int_tensor

__all__ = [
    "chirp_phase_numerators",
    "modulate_ri",
    "downchirp_ri",
    "exact_prefix_sum_mod",
]

PI = np.float32(np.pi)

# Factored tone synthesis above this size (mirrors ops/dft.py's DFT split).
_TX_FACTOR_THRESHOLD = 512


def _wrap_count_prefix(t, b: int):
    """S(t) = sum_{j=0}^{t-1} j // b, exact in int64 (torch or numpy)."""
    q = t // b
    r = t - q * b
    return b * (q * (q - 1) // 2) + q * r


def chirp_phase_numerators(symbols, n: int, osr: int, bw_scale: int,
                           nn: int | None = None):
    """Integer phase numerators for up-chirps.

    Args:
      symbols: integer tensor (..., S) of symbol values (< 2*n).
      n: base samples per symbol (2^sf).
      osr: oversampling ratio.
      bw_scale: integer bandwidth scale (1, 2, 4).
      nn: samples to generate per symbol (default n*osr).

    Returns:
      (num, delta): ``num`` int64 (..., S, nn) phase numerators mod 2*D with
      ``phi = pi * num / D`` and ``D = n * osr**2``; ``delta`` int64 (..., S)
      end-of-symbol numerators for exact phase carry.
    """
    if nn is None:
        nn = n * osr
    d = n * osr * osr
    two_d = 2 * d
    b = n * osr
    sym = int_tensor(symbols)[..., None]                       # (..., S, 1)
    m = torch.arange(1, nn + 1, dtype=torch.int64, device=sym.device)
    c = sym * osr
    w = _wrap_count_prefix(c + m, b) - _wrap_count_prefix(c, b)
    num = (-m * b) + 2 * sym * m * osr + m * (m + 1) - 2 * w * b
    num = torch.remainder(num, two_d)
    num = torch.remainder(num * bw_scale, two_d)
    return num, num[..., -1]


def exact_prefix_sum_mod(delta, mod: int):
    """Exclusive prefix sum of non-negative integers mod ``mod``, int64-exact.

    The JAX package builds this from two limb matmuls because its target
    has no cumsum; an int64 cumsum is exact and is the plain form here.
    """
    delta = int_tensor(delta)
    return torch.remainder(torch.cumsum(delta, dim=-1) - delta, mod)


def _with_sync_prelude(symbols, params: LoraParams):
    """Prepend the two sync-word chirp symbols (LoRaMod.cpp:20-32)."""
    sym = int_tensor(symbols, torch.int32)
    # filled on the device: a host-built tensor would be a blocking copy
    sync = [torch.full(sym.shape[:-1] + (1,), v, dtype=torch.int32,
                       device=sym.device)
            for v in params.sync_nibble_symbols()]
    return torch.cat(sync + [sym], dim=-1)                     # (..., S+2)


def modulate_ri(symbols, params: LoraParams, amplitude: float = 1.0):
    """Modulate symbols into IQ planes (LoRaMod.cpp:8-43).

    Emits the two sync-word chirps followed by one up-chirp per symbol with a
    packet-wide exactly-carried phase.  Batched over any leading axes of
    ``symbols``.  The JAX package's dispatch (``ops/chirp.py:145-168``):
    where a TX kernel covers the configuration (``ops/cuda_tx.py::
    tx_supported``: osr == 1 to n = 4096, osr > 1 with tone modulus
    128 <= n*osr/bw_scale <= 4096), a CUDA tensor is synthesized by it;
    elsewhere (e.g. sf12/BW125/osr2, q = 8192) both devices run the
    closed-form phases, which the JAX package runs as plain XLA on the TPU
    too.  A CPU tensor runs the plain tone lookup at osr == 1 (factored
    above n = 512) and the closed-form phases at osr > 1, as the JAX
    package does off the TPU.  Host data runs on the card
    (``utils/tensors.py::int_tensor``).

    Returns (re, im) float32 tensors of shape (..., (S+2) * n * osr).
    """
    from .cuda_tx import tx_supported, tx_tone_synth
    sym = int_tensor(symbols, torch.int32)
    if sym.is_cuda and tx_supported(params.n, params.osr, params.bw_scale):
        return tx_tone_synth(_with_sync_prelude(sym, params), params,
                             amplitude)
    if params.osr == 1 and not sym.is_cuda:
        return _modulate_ri_mxu(sym, params, amplitude)
    return _modulate_ri_vpu(sym, params, amplitude)


def _modulate_ri_vpu(symbols, params: LoraParams, amplitude: float = 1.0):
    """Closed-form phase synthesis: integer numerators then one sin/cos per
    sample (any osr)."""
    n, osr, bs = params.n, params.osr, params.bw_scale
    nn = n * osr
    d = n * osr * osr
    amplitude = float(np.clip(amplitude, -1.0, 1.0))  # LoRaMod.cpp:18

    sym = int_tensor(symbols)
    allsyms = _with_sync_prelude(sym, params)                  # (..., S+2)

    num, delta = chirp_phase_numerators(allsyms, n, osr, bs, nn)
    start = exact_prefix_sum_mod(delta, 2 * d)                  # (..., S+2)
    phi = (start[..., None] + num).to(torch.float32) * float(
        PI / np.float32(d))
    re = amplitude * torch.cos(phi)
    im = amplitude * torch.sin(phi)
    out_shape = sym.shape[:-1] + (-1,)
    return re.reshape(out_shape), im.reshape(out_shape)


@functools.lru_cache(maxsize=None)
def _tx_base_chirp(n: int, bs: int):
    """(n,) symbol-0 base chirp ``base[m] = exp(j*pi*bs*(m*(m+1) - m*n)/n)``.

    Sample index runs m = 1..n (``genChirp`` integrates phase *before*
    emitting, ChirpGenerator.hpp:37-38, so sample 0 already has one
    frequency step).  Angle arguments are exact integer residues.
    """
    m = np.arange(1, n + 1, dtype=np.int64)
    bnum = np.mod(bs * (m * (m + 1) - m * n), 2 * n)
    bphi = np.pi * bnum.astype(np.float64) / n
    return np.cos(bphi).astype(np.float32), np.sin(bphi).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _tx_tone_tables(n: int):
    """(n, n) tone tables ``w[t, m] = exp(2j*pi*t*m/n)`` at m = 1..n."""
    m = np.arange(1, n + 1, dtype=np.int64)
    t = np.arange(n, dtype=np.int64)
    ang = 2.0 * np.pi * ((t[:, None] * m[None, :]) % n) / n
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _tx_tone_tables_factored(n: int, n2: int):
    """Factored tone tables: ``w1[t1, m1] = exp(2j*pi*t1*m1/n1)`` (n1 = n/n2)
    and ``w2[t, m2] = exp(2j*pi*t*m2/n)`` so that, with m' = m mod n written
    as m' = m1*n2 + m2, ``w[t, m] = w1[t mod n1, m1] * w2[t, m2]``."""
    n1 = n // n2
    t = np.arange(n, dtype=np.int64)
    m1 = np.arange(n1, dtype=np.int64)
    m2 = np.arange(n2, dtype=np.int64)
    a1 = 2.0 * np.pi * ((t[:n1, None] * m1[None, :]) % n1) / n1
    a2 = 2.0 * np.pi * ((t[:, None] * m2[None, :]) % n) / n
    return (np.cos(a1).astype(np.float32), np.sin(a1).astype(np.float32),
            np.cos(a2).astype(np.float32), np.sin(a2).astype(np.float32))


def _modulate_ri_mxu(symbols, params: LoraParams, amplitude: float = 1.0):
    """Tone-table chirp synthesis (osr == 1).

    At osr == 1 the wrap-count term of the integer phase vanishes mod 2*pi
    (2*W*N = 0 mod 2N), so every chirp factors exactly into

        chirp_s[m] = sign_k * base[m] * w^(t*m),  t = (s*bs) mod n

    with ``sign_k`` the carried packet phase (alternating +-1 for bs odd,
    +1 for bs even).  The JAX package forms the tone factor as a one-hot
    matmul against the (n, n) tone table; with exact 0/1 weights that
    product IS a row lookup, which is what this plain form does.  n >= 1024
    uses the two-stage factorization w^(t*m) = w1^(t1*m1) * w2^(t*m2).
    """
    n, bs = params.n, params.bw_scale
    if params.osr != 1:
        raise InvalidArgumentError(
            f"tone-table synthesis needs osr == 1, got {params.osr}")
    amplitude = np.float32(np.clip(amplitude, -1.0, 1.0))  # LoRaMod.cpp:18

    allsyms = _with_sync_prelude(symbols, params).to(torch.int64)
    dev = allsyms.device
    s_total = allsyms.shape[-1]
    tone = torch.remainder(allsyms * bs, n)                    # (..., S+2)

    bc, bsn = device_table(_tx_base_chirp, n, bs, device=dev)
    if n <= _TX_FACTOR_THRESHOLD:
        wc, ws = device_table(_tx_tone_tables, n, device=dev)
        c = wc[tone]
        s_ = ws[tone]
    else:
        n2 = 128
        n1 = n // n2
        w1c, w1s, w2c, w2s = device_table(_tx_tone_tables_factored, n, n2,
                                          device=dev)
        t1 = torch.remainder(tone, n1)
        f1c, f1s = w1c[t1], w1s[t1]                            # (..., S, n1)
        f2c, f2s = w2c[tone], w2s[tone]                        # (..., S, n2)
        # w[t, m1*n2 + m2] = f1[m1] * f2[m2]; m = 1..n maps to
        # m' = m mod n whose digits are (m1, m2) of m' = m1*n2 + m2 —
        # build in digit order then roll so columns follow m = 1..n
        c4 = (f1c[..., :, None] * f2c[..., None, :]
              - f1s[..., :, None] * f2s[..., None, :])
        s4 = (f1c[..., :, None] * f2s[..., None, :]
              + f1s[..., :, None] * f2c[..., None, :])
        c = torch.roll(c4.reshape(c4.shape[:-2] + (n,)), -1, dims=-1)
        s_ = torch.roll(s4.reshape(s4.shape[:-2] + (n,)), -1, dims=-1)

    re = bc * c - bsn * s_
    im = bc * s_ + bsn * c
    if (bs * n) % (2 * n):                                     # bs odd
        sign = torch.as_tensor(
            np.where(np.arange(s_total) % 2 == 0, 1.0, -1.0)
            .astype(np.float32), device=dev)
        re = re * sign[:, None]
        im = im * sign[:, None]
    out_shape = allsyms.shape[:-1] + (s_total * n,)
    amp = float(amplitude)
    return (amp * re).reshape(out_shape), (amp * im).reshape(out_shape)


def downchirp_ri(sf: int, bw_scale: int, osr: int = 1,
                 nn: int | None = None) -> tuple[np.ndarray, np.ndarray]:
    """Reference down-chirp as host numpy constants (phy.cpp:206-208).

    The full-RX demodulator multiplies by a down-chirp generated with
    ``genChirp(..., f0=0, down=true, osr=1)`` whose phase is the negated
    up-chirp phase.  Computed exactly with integer numerators.
    """
    n = 1 << sf
    if nn is None:
        nn = n * osr
    d = n * osr * osr
    b = n * osr
    m = np.arange(1, nn + 1, dtype=np.int64)
    w = _wrap_count_prefix(m, b)  # sym = 0 -> S(m) - S(0)
    num = (-m * b) + m * (m + 1) - 2 * w * b
    num = np.mod(num, 2 * d)
    num = np.mod(num * bw_scale, 2 * d)
    phi = -num.astype(np.float64) * (np.pi / d)   # down: phase -= f
    return np.cos(phi).astype(np.float32), np.sin(phi).astype(np.float32)

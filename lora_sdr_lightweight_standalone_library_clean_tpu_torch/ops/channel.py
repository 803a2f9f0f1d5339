"""Channel models: AWGN, CFO and timing-offset injection, batched.

PyTorch port of ``lora_sdr_lightweight_standalone_library_clean_tpu/ops/
channel.py``.  The reference's only channel tooling rewrites CSVs after the
fact (``scripts/generate_lora_phy_vectors.py:106-128``: a rotation and an
integer shift); here the channel is an op on the planes' device, so BER/PER
sweeps run over batches of packets on the card (``models/sweep.py``).

Where the JAX package takes a PRNG key, ``awgn``/``apply_channel`` take a
``torch.Generator`` on the planes' device: the noise is drawn there, never
on the host.  torch cannot reproduce ``jax.random``'s draws, so the parity
tests feed both packages the same noise through ``_add_noise``.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["awgn", "inject_cfo", "inject_time_offset", "apply_channel"]

TWO_PI = np.float32(2.0 * np.pi)


def _per_row(x, like):
    """A scalar or batched value as a float32 tensor that broadcasts over
    the last axis of ``like`` (the JAX package's trailing ``[..., None]``)."""
    x = torch.as_tensor(x, dtype=torch.float32, device=like.device)
    while x.ndim < like.ndim:
        x = x[..., None]
    return x


def _add_noise(iq_r, iq_i, snr_db, nr, ni):
    """iq + sigma * (nr, ni), sigma = sqrt(1/2) * 10^(-snr_db/20) in
    float32 (the JAX package's ``awgn`` arithmetic on given unit draws)."""
    snr = _per_row(snr_db, iq_r)
    sigma = float(np.float32(np.sqrt(0.5))) * torch.pow(
        torch.tensor(10.0, dtype=torch.float32, device=iq_r.device),
        -snr / 20.0)
    return iq_r + nr * sigma, iq_i + ni * sigma


def awgn(generator: torch.Generator, iq_r, iq_i, snr_db):
    """Add complex white Gaussian noise for a given SNR (dB) relative to
    unit signal power.  ``snr_db`` may be scalar or batched over leading
    axes of ``iq``.  ``generator`` lives on the planes' device, where the
    draws are made (real plane first, then the imaginary one)."""
    nr = torch.randn(iq_r.shape, generator=generator, dtype=torch.float32,
                     device=iq_r.device)
    ni = torch.randn(iq_i.shape, generator=generator, dtype=torch.float32,
                     device=iq_i.device)
    return _add_noise(iq_r, iq_i, snr_db, nr, ni)


def inject_cfo(iq_r, iq_i, cfo_bins, n_step: int,
               per_symbol_phase: bool = True):
    """Rotate by a CFO given in FFT bins (generate_lora_phy_vectors.py:113-117).

    The reference script applies ``exp(2j*pi*cfo*(n % N)/N)``: the phase
    ramp resets each symbol (``per_symbol_phase=True``).  Set False for a
    continuous ramp (physically realistic CFO).
    """
    count = iq_r.shape[-1]
    n = torch.arange(count, dtype=torch.float32, device=iq_r.device)
    if per_symbol_phase:
        n = torch.remainder(n, float(np.float32(n_step)))
    cfo = _per_row(cfo_bins, iq_r)
    ph = float(TWO_PI) * cfo * n / float(np.float32(n_step))
    c, s = torch.cos(ph), torch.sin(ph)
    return iq_r * c - iq_i * s, iq_r * s + iq_i * c


def inject_time_offset(iq_r, iq_i, shift: int):
    """Integer sample shift with zero fill
    (generate_lora_phy_vectors.py:118-125): positive drops leading samples,
    negative prepends zeros."""
    count = iq_r.shape[-1]
    idx = torch.arange(count, device=iq_r.device) + shift
    valid = (idx >= 0) & (idx < count)
    idxc = torch.clamp(idx, 0, count - 1)
    zero = torch.zeros((), dtype=iq_r.dtype, device=iq_r.device)
    return (torch.where(valid, iq_r[..., idxc], zero),
            torch.where(valid, iq_i[..., idxc], zero))


def apply_channel(generator: torch.Generator | None, iq_r, iq_i,
                  snr_db=None, cfo_bins=None, time_offset=None,
                  n_step: int | None = None):
    """Compose impairments: CFO rotation, timing shift, then AWGN
    (``generator`` is needed only with ``snr_db``)."""
    if cfo_bins is not None:
        iq_r, iq_i = inject_cfo(iq_r, iq_i, cfo_bins, n_step)
    if time_offset:
        iq_r, iq_i = inject_time_offset(iq_r, iq_i, int(time_offset))
    if snr_db is not None:
        iq_r, iq_i = awgn(generator, iq_r, iq_i, snr_db)
    return iq_r, iq_i

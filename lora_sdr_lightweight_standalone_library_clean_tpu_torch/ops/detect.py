"""FFT-bin symbol detector: power scan, argmax, noise floor, fractional bin.

PyTorch port of ``lora_sdr_lightweight_standalone_library_clean_tpu/ops/
detect.py`` (reference ``include/lora_phy/LoRaDetector.hpp:16-82``):
DFT (``ops/dft.py``) -> |bin|^2 -> first-max argmax -> signal/noise dB ->
3-point fractional-bin interpolation, batched over leading axes.

Semantics parity:
 - argmax with strictly-greater compare => lowest index wins ties
   (LoRaDetector.hpp:53).  ``torch.argmax`` returns the index of the first
   maximal value on the CPU and on CUDA (its documented contract), which
   matches exactly.
 - power / powerAvg in dB with 20*log10(N) scale (LoRaDetector.hpp:29,60-64).
 - fractional index from circular neighbours with divide-by-zero guard
   (LoRaDetector.hpp:66-71).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .dft import dft_ri

__all__ = ["DetectResult", "detect_ri"]


class DetectResult(NamedTuple):
    """Per-symbol detection outputs (leading axes = batch/symbol axes)."""

    index: torch.Tensor      # int32 argmax bin
    power: torch.Tensor      # fundamental power, dB
    power_avg: torch.Tensor  # average noise power, dB
    findex: torch.Tensor     # fractional frequency offset, bins
    bin_re: torch.Tensor     # complex value of the winning bin
    bin_im: torch.Tensor
    mag2_max: torch.Tensor   # |winning bin|^2 (linear) for tie-break logic


def detect_ri(zr, zi, method: str = "auto") -> DetectResult:
    """Detect the argmax bin of DFT(z) for batched symbols.

    Args:
      zr, zi: float32 (..., N) dechirped (and windowed) symbol samples.
    """
    n = zr.shape[-1]
    xr, xi = dft_ri(zr, zi, method=method)
    mag2 = xr * xr + xi * xi                                  # (..., N)

    idx = torch.argmax(mag2, dim=-1)                          # first max
    max_val = torch.amax(mag2, dim=-1)
    total = torch.sum(mag2, dim=-1)

    fundamental = torch.sqrt(max_val)
    noise = torch.sqrt(torch.clamp(total - max_val, min=0.0))
    scale = float(np.float32(20.0 * np.log10(n)))
    power = 20.0 * torch.log10(fundamental) - scale
    power_avg = 20.0 * torch.log10(noise) - scale

    # the winning bin and its circular neighbours (the JAX package selects
    # them with one-hot masked sums; a gather reads the same values)
    sel = idx[..., None]
    left = torch.sqrt(torch.gather(mag2, -1, torch.remainder(sel - 1, n)))[..., 0]
    right = torch.sqrt(torch.gather(mag2, -1, torch.remainder(sel + 1, n)))[..., 0]
    demon = 2.0 * fundamental - right - left
    findex = torch.where(demon == 0.0, torch.zeros_like(demon),
                         0.5 * (right - left) / demon)

    bin_re = torch.gather(xr, -1, sel)[..., 0]
    bin_im = torch.gather(xi, -1, sel)[..., 0]
    return DetectResult(idx.to(torch.int32), power, power_avg, findex,
                        bin_re, bin_im, max_val)

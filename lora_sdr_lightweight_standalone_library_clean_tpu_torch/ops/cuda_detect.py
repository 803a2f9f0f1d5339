"""Rotate-detect: the hand-written CUDA kernel (#8) and its plain form.

Counterpart of ``lora_sdr_lightweight_standalone_library_clean_tpu/ops/
pallas_detect.py``: the kernel ``_detect_kernel`` that
``fused_rotate_detect`` runs, the second stage of the two-stage detect
route (``models/tones.py::_rotate_detect``, ``backend="pallas"``).  Per
row (b, s) of windows that the caller already timing-shifted, dechirped
and windowed it

  (a) rotates the n samples by ``e^{j(start[b, s] + rate[b]*i)}``;
  (b) takes the n-point DFT and |X|^2;
  (c) returns the first-max bin, ``20log10(sqrt(max)) - 20log10(n)`` and
      ``20log10(sqrt(sum - max)) - 20log10(n)``.

``fused_rotate_detect`` lets the device of its input decide: on a CPU
tensor it runs ``fused_rotate_detect_ref`` (the same steps in torch, then
``detect_ri``); on a CUDA tensor it launches ``csrc/rotate_detect.cu``, the
``RowReader`` instance of ``rx_dense``, for n = 4 ... 512 (the JAX kernel's
``PALLAS_MAX_N``); above that it raises ``InvalidArgumentError``: sf10-12
take the fused RX kernel, ``backend="auto"``.  The launch path runs in the
span ``lora.kernel.rotate_detect``, and each launch adds one to
``COUNTS["launch.rotate_detect"]`` (``utils/spans.py``).

Kernel note.  Replaces ``ops/pallas_detect.py:_detect_kernel``, which
multiplies tiles of rows by dense (n, n) cos/sin DFT matrices on the TPU's
MXU.  Here each row is one RX window: the rotation with the accurate
sincosf, then ``rx_dense``'s FFT in registers and shuffles
(``csrc/rx_fft.cuh``), the first-max rule and the dB epilogue of
``rx_common.cuh``.  The floor is the one read of the rows,
8 bytes a sample; rotations and spectra stay out of device memory.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils import cuda_build
from ..utils.errors import InvalidArgumentError
from ..utils.spans import count, span
from ..utils.tensors import device_table
from .cuda_rx import _checked, _fft_tables
from .detect import detect_ri

__all__ = ["fused_rotate_detect", "fused_rotate_detect_ref",
           "DETECT_MAX_N"]

DETECT_MAX_N = 512        # PALLAS_MAX_N


def fused_rotate_detect_ref(zr, zi, rate, start):
    """Plain PyTorch version of the rotate-detect kernel (any device).

    Args:
      zr, zi: float32 (B, S, N) symbol windows (already dechirped and
        windowed).
      rate: float32 (B,) per-packet derotation rate (phy.cpp:202).
      start: float32 (B, S) per-symbol phase offsets (phy.cpp:218-219).

    Returns (index int32, power_db, noise_db), each (B, S).
    """
    n = zr.shape[-1]
    ph = start[..., None] + rate[..., None, None] * torch.arange(
        n, dtype=torch.float32, device=zr.device)
    c, s = torch.cos(ph), torch.sin(ph)
    ar = zr * c - zi * s
    ai = zr * s + zi * c
    det = detect_ri(ar, ai)
    return det.index, det.power, det.power_avg


def fused_rotate_detect(zr, zi, rate, start):
    """Rotate, DFT and detect each row of symbol windows.

    Same contract as ``fused_rotate_detect_ref``.  A CPU input runs the
    plain version; a CUDA input launches ``csrc/rotate_detect.cu`` and must
    be contiguous float32 with N a power of two in 4 ... 512 (else
    ``InvalidArgumentError``).
    """
    if not zr.is_cuda:
        return fused_rotate_detect_ref(zr, zi, rate, start)
    with span("lora.kernel.rotate_detect"):
        if zr.ndim != 3:
            raise ValueError(f"zr must be (B, S, N), got {tuple(zr.shape)}")
        b, s, n = zr.shape
        if n & (n - 1) or not 4 <= n <= DETECT_MAX_N:
            raise InvalidArgumentError(
                f"the rotate-detect kernel takes 4 ... {DETECT_MAX_N}-point "
                f"windows, got {n}: sf10-12 take backend='auto', the fused RX "
                "kernel")
        dev = zr.device
        zr = _checked(zr, "zr", torch.float32, (b, s, n), dev)
        zi = _checked(zi, "zi", torch.float32, (b, s, n), dev)
        rate = _checked(rate, "rate", torch.float32, (b,), dev)
        start = _checked(start, "start", torch.float32, (b, s), dev)
        if b * s >= 2 ** 31:
            raise ValueError(f"{b * s} rows exceed the kernel's 32-bit row "
                             "indexing")
        idx = torch.empty((b, s), dtype=torch.int32, device=dev)
        pw = torch.empty((b, s), dtype=torch.float32, device=dev)
        pav = torch.empty((b, s), dtype=torch.float32, device=dev)
        if b * s == 0:
            return idx, pw, pav
        tw, bins = device_table(_fft_tables, n, device=dev)
        scale_db = float(np.float32(20.0 * np.log10(n)))
        lib = cuda_build.load()
        with torch.cuda.device(dev):
            err = lib.lora_rotate_detect(
                zr.data_ptr(), zi.data_ptr(), rate.data_ptr(),
                start.data_ptr(), tw.data_ptr(), bins.data_ptr(), b, s, n,
                scale_db, idx.data_ptr(), pw.data_ptr(), pav.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise RuntimeError(
                f"lora_rotate_detect launch failed: cudaError_t {err}")
        count("launch.rotate_detect")
        return idx, pw, pav

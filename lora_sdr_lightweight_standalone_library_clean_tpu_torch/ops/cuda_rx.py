"""Fused packet RX: the hand-written CUDA kernel and its plain form.

Counterpart of ``lora_sdr_lightweight_standalone_library_clean_tpu/ops/
pallas_rx.py`` for osr == 1, n <= 4096, ``wide=False`` and no halo: the
kernel ``_rx_kernel`` that ``_rx_call`` runs in its direct-window form,
with the dense DFT (n <= 512) or the hybrid DFT (n = 1024 ... 4096).  Per
packet b and symbol s it

  (a) takes the timing-shifted window ``stream[b, s*n + t + i]`` with the
      reference edge clamp (``phy.cpp:209-216``): symbol 0 reads unshifted
      when t < 0, symbol S-1 when t > 0;
  (b) multiplies by ``scale[b] * e^{j*rate[b]*(s*n + t + i)} * mult[i]``;
  (c) takes the n-point DFT and |X|^2;
  (d) returns the first-max bin, ``20log10(sqrt(max)) - 20log10(n)`` and
      ``20log10(sqrt(sum - max)) - 20log10(n)``.

``rx_window_detect`` lets the device of its input decide: on a CPU tensor it
runs ``rx_window_detect_ref``, the torch form of the JAX package's jnp path
(``_timing_shifted_windows``, the rotation ``start + rate*i`` of
``models/tones.py:95-97,145-149``, the multiplier, then ``detect_ri`` on a
``torch.matmul`` DFT: dense to n = 512, ``ops/dft.py``'s four-step product
above); on a CUDA tensor it launches ``csrc/rx_dense.cu`` (n <= 512) or
``csrc/rx_hybrid.cu`` (n = 1024 ... 4096), or raises.  Each launch adds one
to its kernel's count (``DENSE_LAUNCHES`` or ``HYBRID_LAUNCHES``) and to
their sum ``KERNEL_LAUNCHES``.

Non-finite input is outside this slice's contract and no test feeds it.
Where |X|^2 holds a NaN, both versions follow the jnp rule: the first NaN
bin wins, as ``torch.argmax`` and ``jnp.argmax`` pick it.  (The TPU
kernel's float first-max returns the out-of-range bin n instead,
``pallas_rx.py:326``.)

Kernel note.  Replaces ``ops/pallas_rx.py:_rx_kernel`` (direct window;
dense and hybrid DFT).  On the H100 the floor is the one read of the
stream, 8 bytes per sample; the compute per sample is one sincos, the
rotation multiplies and log2(n) shared-memory FFT stages.  The TPU
multiplies by a dense DFT matrix, or runs DIF passes into a 128-point DFT
matmul, because it has no FFT; the kernels run a radix-2 FFT in shared
memory, in float32 with twiddles built in float64, and keep windows and
spectra out of device memory, 12 bytes written per window.  ``rx_dense``
gives each window n/2 threads (as many windows per block as make 128
threads when n < 256); ``rx_hybrid`` gives each window one 512-thread
block, n/1024 butterflies per thread and stage.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils import cuda_build
from ..utils.config import LoraParams
from ..utils.tensors import device_table
from .detect import detect_ri

__all__ = ["rx_window_detect", "rx_window_detect_ref", "KERNEL_LAUNCHES",
           "DENSE_LAUNCHES", "HYBRID_LAUNCHES", "RX_DENSE_MAX_N", "RX_MAX_N"]

RX_DENSE_MAX_N = 512      # rx_dense.cu; rx_hybrid.cu above
RX_MAX_N = 4096
DENSE_LAUNCHES = 0
HYBRID_LAUNCHES = 0
KERNEL_LAUNCHES = 0       # DENSE_LAUNCHES + HYBRID_LAUNCHES


def _require_supported(params: LoraParams, wide: bool, halo) -> None:
    """Raise ``NotImplementedError`` naming the ROADMAP item for what the
    kernel does not cover yet."""
    if wide or tuple(halo) != (0, 0):
        raise NotImplementedError(
            "the wide/halo RX detect is not ported yet: it is ROADMAP kernel "
            "items #5 at 8192/16384 points and #6 "
            "(ops/pallas_rx.py::_rx_kernel hybrid and padded/halo forms)")
    if params.osr != 1:
        raise NotImplementedError(
            f"the RX kernel at osr={params.osr} is not ported yet: it is "
            "ROADMAP kernel item #6 (ops/pallas_rx.py::_rx_kernel "
            "padded/slab form)")
    if params.n > RX_MAX_N:
        raise NotImplementedError(
            f"the RX kernel at n={params.n} is not ported yet: it is ROADMAP "
            "kernel item #5 at 8192/16384 points "
            "(ops/pallas_rx.py::_rx_kernel hybrid DFT)")


def _fft_twiddles(n: int) -> tuple[np.ndarray, np.ndarray]:
    """(n/2,) FFT twiddles exp(-2j*pi*k/n) as (cos, sin) planes, float64
    math rounded to float32 (up to 2048 entries at n = 4096)."""
    ang = 2.0 * np.pi * np.arange(n // 2, dtype=np.float64) / n
    return np.cos(ang).astype(np.float32), (-np.sin(ang)).astype(np.float32)


def rx_window_detect_ref(stream_r, stream_i, t_off, rate, scale, mult_r,
                         mult_i, params: LoraParams, *, wide: bool = False,
                         halo: tuple = (0, 0)):
    """Plain PyTorch version of the fused RX (any device).

    Args:
      stream_r/i: float32 (..., S * step) packet sample streams.
      t_off: int32 (...,) per-packet timing shift, |t_off| <= step.
      rate: float32 (...,) CFO derotation rate per sample (-2*pi*cfo/n).
      scale: float32 (...,) per-packet amplitude normalization.
      mult_r/i: float32 (n,) per-sample multiplier (the window, or ones,
        with zeros for the pre-dechirped tones path).
      params: LoraParams.

    Returns (index int32, power_db, noise_db), each (..., S).
    """
    if wide or tuple(halo) != (0, 0):
        _require_supported(params, wide, halo)
    from ..models.modem import _timing_shifted_windows
    n, osr, step = params.n, params.osr, params.step
    total = stream_r.shape[-1] // step
    dev = stream_r.device
    zr, zi = _timing_shifted_windows(stream_r, stream_i, t_off, total, step,
                                     osr, n)
    zr = zr * scale[..., None, None]
    zi = zi * scale[..., None, None]
    s_idx = torch.arange(total, dtype=torch.float32, device=dev) * float(n)
    start = rate[..., None] * (
        s_idx + t_off.to(torch.float32)[..., None] / float(osr))
    ph = start[..., None] + rate[..., None, None] * torch.arange(
        n, dtype=torch.float32, device=dev)
    c, s_ = torch.cos(ph), torch.sin(ph)
    fr = zr * c - zi * s_
    fi = zr * s_ + zi * c
    ar = fr * mult_r - fi * mult_i
    ai = fr * mult_i + fi * mult_r
    det = detect_ri(ar, ai)
    return det.index, det.power, det.power_avg


def _checked(x, name: str, dtype, shape, device) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor")
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    return x


def rx_window_detect(stream_r, stream_i, t_off, rate, scale, mult_r, mult_i,
                     params: LoraParams, *, wide: bool = False,
                     halo: tuple = (0, 0)):
    """Fused RX: timing-shifted windows + rotation/multiplier + DFT + detect.

    Same contract as ``rx_window_detect_ref``.  A CPU input runs the plain
    version; a CUDA input launches ``csrc/rx_dense.cu`` (n <= 512) or
    ``csrc/rx_hybrid.cu`` (n = 1024 ... 4096) and raises
    ``NotImplementedError`` for osr > 1, ``wide`` or a halo.  On CUDA every
    input must be contiguous and of the stated dtype.
    """
    global KERNEL_LAUNCHES, DENSE_LAUNCHES, HYBRID_LAUNCHES
    if not stream_r.is_cuda:
        return rx_window_detect_ref(stream_r, stream_i, t_off, rate, scale,
                                    mult_r, mult_i, params, wide=wide,
                                    halo=halo)
    _require_supported(params, wide, halo)
    n = params.n
    dev = stream_r.device
    lead = tuple(stream_r.shape[:-1])
    length = stream_r.shape[-1]
    s_real = length // n
    if s_real * n != length or s_real == 0:
        raise ValueError(f"stream length {length} is not a positive "
                         f"multiple of n={n}")
    sr = _checked(stream_r, "stream_r", torch.float32, lead + (length,), dev)
    si = _checked(stream_i, "stream_i", torch.float32, lead + (length,), dev)
    t = _checked(t_off, "t_off", torch.int32, lead, dev)
    r = _checked(rate, "rate", torch.float32, lead, dev)
    sc = _checked(scale, "scale", torch.float32, lead, dev)
    mr = _checked(mult_r, "mult_r", torch.float32, (n,), dev)
    mi = _checked(mult_i, "mult_i", torch.float32, (n,), dev)
    bsz = int(np.prod(lead)) if lead else 1
    if bsz * s_real >= 2 ** 31:
        raise ValueError(f"{bsz * s_real} windows exceed the kernel's "
                         "32-bit window indexing")
    idx = torch.empty(lead + (s_real,), dtype=torch.int32, device=dev)
    pw = torch.empty(lead + (s_real,), dtype=torch.float32, device=dev)
    pav = torch.empty(lead + (s_real,), dtype=torch.float32, device=dev)
    if bsz == 0:
        return idx, pw, pav
    twr, twi = device_table(_fft_twiddles, n, device=dev)
    scale_db = float(np.float32(20.0 * np.log10(n)))
    dense = n <= RX_DENSE_MAX_N
    name = "lora_rx_dense" if dense else "lora_rx_hybrid"
    launch = getattr(cuda_build.load(), name)
    with torch.cuda.device(dev):
        err = launch(
            sr.data_ptr(), si.data_ptr(), t.data_ptr(), r.data_ptr(),
            sc.data_ptr(), mr.data_ptr(), mi.data_ptr(), twr.data_ptr(),
            twi.data_ptr(), bsz, s_real, n, scale_db, idx.data_ptr(),
            pw.data_ptr(), pav.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"{name} launch failed: cudaError_t {err}")
    KERNEL_LAUNCHES += 1
    if dense:
        DENSE_LAUNCHES += 1
    else:
        HYBRID_LAUNCHES += 1
    return idx, pw, pav

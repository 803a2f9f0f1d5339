"""Fused packet RX: the hand-written CUDA kernels and their plain form.

Counterpart of ``lora_sdr_lightweight_standalone_library_clean_tpu/ops/
pallas_rx.py``: the kernel ``_rx_kernel`` that ``_rx_call`` runs, in its
direct-window form (osr == 1), its padded/slab form (decimated osr > 1) and
its halo variant, with the dense DFT (n <= 512) or the hybrid DFT (n = 1024
... 16384).  Per packet b and detected symbol s it

  (a) takes the timing-shifted window ``stream[b, s*step + t + i*osr]``,
      i < n, with the reference edge clamp (``phy.cpp:209-216``): symbol 0
      reads its unshifted samples at phase 0 when t < 0, symbol S-1 when
      t > 0;
  (b) multiplies by ``scale[b] * e^{j*rate[b]*(s*n + t/osr + i)} * mult[i]``;
  (c) takes the n-point DFT and |X|^2;
  (d) returns the first-max bin, ``20log10(sqrt(max)) - 20log10(n)`` and
      ``20log10(sqrt(sum - max)) - 20log10(n)``.

``wide=True`` detects over the full-rate grid instead (the injective wide
receiver, ``models/modem.py::demodulate_wide``): n*osr points, osr 1 in the
window, a multiplier of n*osr samples (``pallas_rx.py:831-834``).
``halo=(h0, h1)`` reads h0 leading and h1 trailing stream rows without
detecting them (osr 1 in the window only, as in the JAX package); the edge
clamp keys on the stream row, the rotation on the detected row s - h0.

``rx_window_detect`` lets the device of its input decide: on a CPU tensor it
runs ``rx_window_detect_ref``, the torch form of the JAX package's jnp path
(``_timing_shifted_windows``, the rotation ``start + rate*i`` of
``models/tones.py:95-97,145-149``, the multiplier, then ``detect_ri`` on a
``torch.matmul`` DFT: dense to n = 512, ``ops/dft.py``'s four-step product
above); on a CUDA tensor it launches ``csrc/rx_dense.cu`` (n <= 512) or
``csrc/rx_hybrid.cu`` (n = 1024 ... 16384) for osr-1 windows without a
halo, and ``csrc/rx_osr.cu`` for decimated osr > 1 windows and halos.
The launch path runs in the span ``lora.kernel.<kernel>``, and each launch
adds one to ``COUNTS["launch.<kernel>"]`` (``utils/spans.py``), the kernel
being ``rx_dense``, ``rx_hybrid`` or ``rx_osr``.

Non-finite input: where |X|^2 holds a NaN, both versions follow the jnp
rule: the first NaN bin wins, as ``torch.argmax`` and ``jnp.argmax`` pick
it.  ``tests/test_torch_modem.py`` holds the plain version to JAX's jnp
``demodulate_tones`` on a window with one NaN sample on the CPU, and
``tests/test_torch_cuda.py`` the kernels to the plain version on the card.
(The TPU kernel's float first-max returns the out-of-range bin n instead,
``pallas_rx.py:326``.)

Kernel note.  Replaces ``ops/pallas_rx.py:_rx_kernel`` (direct window,
padded/slab osr > 1 window and halo; dense and hybrid DFT).  On the H100
the floor is the one read of the stream, 8 bytes per sample (a strided
osr > 1 read still moves every sector); the compute per detected sample is
one sincos, the rotation multiplies and the FFT.  The TPU multiplies by a
dense DFT matrix, or runs DIF passes into a 128-point DFT matmul, because
it has no FFT; the kernels run an in-place mixed-radix DIF FFT in float32
(``csrc/rx_fft.cuh``) whose radices, float64-built twiddles and
natural-bin map come from ``_fft_plan`` here, and keep windows and spectra
out of device memory, 12 bytes written per window.  Each thread holds 16
values in registers.  ``rx_dense`` gives a window n/16 lanes of one warp
(a lane per window to n = 16) that exchange by shuffles, with no shared
memory and no block barrier; ``rx_hybrid`` gives a window one block of
n/16 threads, radix-16 passes in registers and 2-3 exchanges through a
padded, bank-conflict-free float2 plane in shared memory (136 KB at
16384).  Spectra stay in digit-reversed order: the first-max reduction
reads each value's natural bin from the plan.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..utils import cuda_build
from ..utils.config import LoraParams
from ..utils.errors import InvalidArgumentError
from ..utils.spans import count, span
from ..utils.tensors import device_table
from .detect import detect_ri

__all__ = ["rx_window_detect", "rx_window_detect_ref", "RX_DENSE_MAX_N",
           "RX_MAX_N"]

RX_DENSE_MAX_N = 512      # rx_dense.cu; rx_hybrid.cu above
RX_MAX_N = 16384          # the wide receiver's sf12/osr4 grid


def _geometry(params: LoraParams, wide: bool, halo) -> tuple[int, int]:
    """(ndft, osr_k): the detection size and the window's decimation
    (``pallas_rx.py:831-834``).  Raises ``InvalidArgumentError`` outside
    the kernels' domain: a DFT size that is not a power of two in
    4 ... 16384, or a halo on decimated windows (the JAX package asserts
    ``halo == (0, 0) or osr == 1``, ``pallas_rx.py:711``)."""
    ndft, osr_k = (params.step, 1) if wide else (params.n, params.osr)
    if ndft & (ndft - 1) or not 4 <= ndft <= RX_MAX_N:
        raise InvalidArgumentError(
            f"a {ndft}-point detection is outside the RX kernels' domain "
            f"(powers of two from 4 to {RX_MAX_N})")
    h0, h1 = halo
    if h0 < 0 or h1 < 0 or ((h0 or h1) and osr_k != 1):
        raise InvalidArgumentError(
            f"halo {tuple(halo)} needs osr 1 in the window (wide=True or "
            f"osr == 1), got osr {osr_k}")
    return ndft, osr_k


def _fft_twiddles(n: int) -> tuple[np.ndarray, np.ndarray]:
    """(n/2,) FFT twiddles exp(-2j*pi*k/n) as (cos, sin) planes, float64
    math rounded to float32 (up to 8192 entries at n = 16384)."""
    ang = 2.0 * np.pi * np.arange(n // 2, dtype=np.float64) / n
    return np.cos(ang).astype(np.float32), (-np.sin(ang)).astype(np.float32)


# W_16^k = exp(-2j*pi*k/16), k < 8, as (re, im): the compile-time constants
# of the kernels' in-register DFTs (csrc/rx_fft.cuh: w16_re, w16_im), float64
# math rounded to float32, with W_16^0 = 1 and W_16^4 = -j exact.
_W16 = np.stack([np.cos(2.0 * np.pi * np.arange(8) / 16),
                 -np.sin(2.0 * np.pi * np.arange(8) / 16)], axis=1)
_W16 = np.where(np.abs(_W16) < 1e-12, 0.0, _W16).astype(np.float32)

RX_VALUES = 16            # complex values per thread in the RX kernels' FFT


class FftPlan(NamedTuple):
    """The RX kernels' FFT for one size n (csrc/rx_fft.cuh).

    radices: the passes' radices, first to last.
    threads: threads (lanes) per window; each holds n / threads values.
    warp: True for rx_dense (n <= 512: the window's lanes exchange by
      shuffles, data stays in place), False for rx_hybrid (one block per
      window; passes exchange through shared memory).
    tw: float32 (K, 2) twiddles: for each pass p but the last,
      W_{L_p}^{m*s} at row table(p) + (s-1)*L_{p+1} + m, s = 1 ... r_p-1,
      m < L_{p+1} (L_p = n / (r_0 ... r_{p-1})).
    bins: int32 (n,) the natural bin of the value that thread t of a
      window holds in register v at the end, at bins[v * threads + t].
    """
    radices: tuple
    threads: int
    warp: bool
    tw: np.ndarray
    bins: np.ndarray


def _fft_radices(n: int) -> tuple:
    """rx_dense (n <= 512): one in-register pass of min(n, 16) points, then
    radix-2 passes across the window's n / 16 lanes.  rx_hybrid: radix-16
    passes, then one radix-2/4/8 pass where log2(n) is not a multiple of
    4."""
    if n <= RX_DENSE_MAX_N:
        v = min(n, RX_VALUES)
        return (v,) + (2,) * int(np.log2(n // v))
    full = int(np.log2(n)) // 4
    rem = n >> (4 * full)
    return (RX_VALUES,) * full + ((rem,) if rem > 1 else ())


def _brev(j: int, r: int) -> int:
    """j with its log2(r) bits reversed."""
    return int(format(j, f"0{int(np.log2(r))}b")[::-1], 2) if r > 1 else 0


def _natural_bin(a: int, radices) -> int:
    """The natural bin of address a at the end of the in-place DIF: a has
    digit s_p at place L_{p+1}, the bin has it at place r_0 ... r_{p-1}."""
    n = int(np.prod(radices))
    span, place, k = n, 1, 0
    for r in radices:
        span //= r
        k += (a // span % r) * place
        place *= r
    return k


def _fft_plan(n: int) -> FftPlan:
    """The pass plan, twiddle table and bin map of the n-point RX FFT."""
    radices = _fft_radices(n)
    warp = n <= RX_DENSE_MAX_N
    values = min(n, RX_VALUES)
    threads = n // values
    cos, sin = _fft_twiddles(n)
    # W_n^k for k < n from the n/2-entry table: W_n^(k + n/2) = -W_n^k
    full = np.concatenate([np.stack([cos, sin], 1),
                           -np.stack([cos, sin], 1)]).astype(np.float32)
    rows, span = [], n
    for r in radices[:-1]:
        lq = span // r
        s = np.arange(1, r)[:, None]
        m = np.arange(lq)[None, :]
        rows.append(full[(m * s * (n // span)).reshape(-1)])
        span = lq
    tw = (np.concatenate(rows) if rows
          else np.zeros((0, 2), np.float32))
    bins = np.empty(n, np.int32)
    last = radices[-1]
    for v in range(values):
        for t in range(threads):
            if warp:         # register v holds output brev(v) of pass 0
                a = _brev(v, values) * threads + t
            else:            # butterfly t + g*threads of the last pass
                g, j = divmod(v, last)
                a = (t + g * threads) * last + _brev(j, last)
            bins[v * threads + t] = _natural_bin(a, radices)
    return FftPlan(radices, threads, warp, tw, bins)


def _fft_tables(n: int) -> tuple[np.ndarray, np.ndarray]:
    """(tw, bins) of ``_fft_plan(n)``, the tables the kernels read."""
    plan = _fft_plan(n)
    return plan.tw, plan.bins


def rx_window_detect_ref(stream_r, stream_i, t_off, rate, scale, mult_r,
                         mult_i, params: LoraParams, *, wide: bool = False,
                         halo: tuple = (0, 0)):
    """Plain PyTorch version of the fused RX (any device).

    Args:
      stream_r/i: float32 (..., S * step) packet sample streams.
      t_off: int32 (...,) per-packet timing shift, |t_off| <= step.
      rate: float32 (...,) CFO derotation rate per detection sample
        (-2*pi*cfo/n decimated; -2*pi*cfo/(n*osr) wide).
      scale: float32 (...,) per-packet amplitude normalization.
      mult_r/i: float32 (ndft,) per-sample multiplier (the window, or ones,
        with zeros for the pre-dechirped tones path), ndft = n decimated,
        n*osr wide.
      params: LoraParams.
      wide: detect over the full-rate (n*osr)-point grid.
      halo: (lead, trail) stream rows read but not detected (osr 1 in the
        window only).

    Returns (index int32, power_db, noise_db), each (..., S - lead - trail).
    """
    from ..models.modem import _timing_shifted_windows
    ndft, osr_k = _geometry(params, wide, halo)
    step = params.step
    h0, h1 = halo
    total = stream_r.shape[-1] // step
    nd = total - h0 - h1
    dev = stream_r.device
    zr, zi = _timing_shifted_windows(stream_r, stream_i, t_off, total, step,
                                     osr_k, ndft)
    zr = zr[..., h0:h0 + nd, :] * scale[..., None, None]
    zi = zi[..., h0:h0 + nd, :] * scale[..., None, None]
    s_idx = torch.arange(nd, dtype=torch.float32, device=dev) * float(ndft)
    start = rate[..., None] * (
        s_idx + t_off.to(torch.float32)[..., None] / float(osr_k))
    ph = start[..., None] + rate[..., None, None] * torch.arange(
        ndft, dtype=torch.float32, device=dev)
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
    ``csrc/rx_hybrid.cu`` (n = 1024 ... 16384) for osr-1 windows without a
    halo, ``csrc/rx_osr.cu`` for decimated (osr > 1) windows and halos.  On
    CUDA every input must be contiguous and of the stated dtype.
    """
    if not stream_r.is_cuda:
        return rx_window_detect_ref(stream_r, stream_i, t_off, rate, scale,
                                    mult_r, mult_i, params, wide=wide,
                                    halo=halo)
    ndft, osr_k = _geometry(params, wide, halo)
    h0, h1 = halo
    if osr_k > 1 or h0 or h1:
        kernel = "rx_osr"
    else:
        kernel = "rx_dense" if ndft <= RX_DENSE_MAX_N else "rx_hybrid"
    with span("lora.kernel." + kernel):
        step = params.step
        dev = stream_r.device
        lead = tuple(stream_r.shape[:-1])
        length = stream_r.shape[-1]
        s_real = length // step
        nd = s_real - h0 - h1
        if s_real * step != length or nd <= 0:
            raise ValueError(f"stream length {length} is not a multiple of "
                             f"step={step} with more than {h0 + h1} symbols")
        plane = lead + (length,)
        sr = _checked(stream_r, "stream_r", torch.float32, plane, dev)
        si = _checked(stream_i, "stream_i", torch.float32, plane, dev)
        t = _checked(t_off, "t_off", torch.int32, lead, dev)
        r = _checked(rate, "rate", torch.float32, lead, dev)
        sc = _checked(scale, "scale", torch.float32, lead, dev)
        mr = _checked(mult_r, "mult_r", torch.float32, (ndft,), dev)
        mi = _checked(mult_i, "mult_i", torch.float32, (ndft,), dev)
        bsz = int(np.prod(lead)) if lead else 1
        if bsz * s_real >= 2 ** 31:
            raise ValueError(f"{bsz * s_real} windows exceed the kernel's "
                             "32-bit window indexing")
        idx = torch.empty(lead + (nd,), dtype=torch.int32, device=dev)
        pw = torch.empty(lead + (nd,), dtype=torch.float32, device=dev)
        pav = torch.empty(lead + (nd,), dtype=torch.float32, device=dev)
        if bsz == 0:
            return idx, pw, pav
        tw, bins = device_table(_fft_tables, ndft, device=dev)
        scale_db = float(np.float32(20.0 * np.log10(ndft)))
        lib = cuda_build.load()
        head = (sr.data_ptr(), si.data_ptr(), t.data_ptr(), r.data_ptr(),
                sc.data_ptr(), mr.data_ptr(), mi.data_ptr(), tw.data_ptr(),
                bins.data_ptr())
        tail = (scale_db, idx.data_ptr(), pw.data_ptr(), pav.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
        if kernel == "rx_osr":
            args = head + (bsz, s_real, ndft, osr_k, h0, h1) + tail
        else:
            args = head + (bsz, s_real, ndft) + tail
        with torch.cuda.device(dev):
            err = getattr(lib, "lora_" + kernel)(*args)
        if err:
            raise RuntimeError(
                f"lora_{kernel} launch failed: cudaError_t {err}")
        count("launch." + kernel)
        return idx, pw, pav

"""Streaming scan: the hand-written CUDA kernel (#7) and its plain form.

Counterpart of ``lora_sdr_lightweight_standalone_library_clean_tpu/ops/
pallas_stream.py``: the kernel ``_stream_kernel`` that ``_stream_call`` runs
for ``stream_window_detect``, which ``parallel/streaming.py::_scan_block``
calls for every stride-aligned window of a continuous stream.  Per stream b
and window w (window w starts at sample ``w * stride`` of the oversampled
stream) it

  (a) reads the n samples ``ext[b, w*stride + i*osr]``, zero past the end
      of ``ext`` (the JAX package pads with zeros, ``streaming.py:76-78``,
      so those windows give -inf dB);
  (b) multiplies them by the scan down-chirp (``parallel/streaming.py::
      _scan_downchirp``, the full-rate down-chirp at the phase-0
      decimation points), or by ``dcr``/``dci`` when given;
  (c) takes the n-point DFT and |X|^2;
  (d) returns the first-max bin, ``20log10(sqrt(max)) - 20log10(n)`` and
      ``20log10(sqrt(sum - max)) - 20log10(n)``, in window order.

``stream_window_detect`` lets the device of its input decide: on a CPU
tensor it runs ``stream_window_detect_ref``, the torch form of the JAX
package's jnp branch of ``_scan_block`` (``_stride_windows``, the
down-chirp product, ``detect_ri``); on a CUDA tensor it launches
``csrc/stream_scan.cu``, the ``StreamReader`` instances of ``rx_dense``
(n <= 512) and ``rx_hybrid`` (n = 1024 ... 4096).  The launch path runs in
the span ``lora.kernel.stream_scan``, and each launch adds one to
``COUNTS["launch.stream_scan"]`` (``utils/spans.py``).  Its domain on the
card is the JAX kernel's: ``osr | stride``, ``stride | step`` and n <=
4096, any number of leading stream axes; outside it the wrapper raises
``InvalidArgumentError``.

Kernel note.  Replaces ``ops/pallas_stream.py:_stream_kernel``.  The TPU
kernel rolls lanes of a VMEM slab to build the step/stride window phases,
stacks them into MXU tiles and multiplies by a dense (or DIF-factored) DFT
matrix, after decimating the stream when osr > 1.  Here every window is
one RX window (``rx_common.cuh``) whose threads read their samples straight
from device memory with stride osr, multiply by the down-chirp (no
rotation, no sincos) and run the RX kernels' FFT (``csrc/rx_fft.cuh``,
``cuda_rx._fft_plan``); at stride step/4 each sample lies in four windows,
and L2 carries that overlap.  Sample offsets
are 64-bit, so a stream may pass 2^31 samples.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils import cuda_build
from ..utils.config import LoraParams
from ..utils.errors import InvalidArgumentError
from ..utils.spans import count, span
from ..utils.tensors import device_table
from .cuda_rx import _checked, _fft_tables
from .detect import detect_ri

__all__ = ["stream_window_detect", "stream_window_detect_ref",
           "STREAM_MAX_N"]

STREAM_MAX_N = 4096       # PALLAS_STREAM_MAX_N


def _down_chirp(params: LoraParams, dcr, dci, device):
    if dcr is not None:
        return dcr, dci
    from ..parallel.streaming import _scan_downchirp
    return device_table(_scan_downchirp, params, device=device)


def stream_window_detect_ref(ext_r, ext_i, params: LoraParams, stride: int,
                             windows: int, dcr=None, dci=None):
    """Plain PyTorch version of the streaming scan (any device).

    Args:
      ext_r/ext_i: float32 (..., T) streams; reads past T are zeros.
      stride: window spacing in oversampled samples; ``stride | step``.
      windows: number of windows to emit.
      dcr/dci: optional (n,) multiplier (default: the scan down-chirp).

    Returns (index int32, power_db, noise_db), each (..., windows).
    """
    from ..parallel.streaming import _stride_windows
    n, osr, step = params.n, params.osr, params.step
    dcr, dci = _down_chirp(params, dcr, dci, ext_r.device)
    total = windows * stride
    zr = _stride_windows(ext_r, total, step, stride, n, osr)
    zi = _stride_windows(ext_i, total, step, stride, n, osr)
    fr = zr * dcr - zi * dci
    fi = zr * dci + zi * dcr
    det = detect_ri(fr, fi)
    return det.index, det.power, det.power_avg


def stream_window_detect(ext_r, ext_i, params: LoraParams, stride: int,
                         windows: int, dcr=None, dci=None):
    """Dechirp-detect ``windows`` stride-aligned windows of each stream.

    Same contract as ``stream_window_detect_ref``.  A CPU input runs the
    plain version; a CUDA input launches ``csrc/stream_scan.cu`` and must
    be contiguous float32, with ``osr | stride``, ``stride | step`` and
    n <= 4096 (else ``InvalidArgumentError``).
    """
    if not ext_r.is_cuda:
        return stream_window_detect_ref(ext_r, ext_i, params, stride,
                                        windows, dcr, dci)
    with span("lora.kernel.stream_scan"):
        n, osr, step = params.n, params.osr, params.step
        if stride < 1 or stride % osr or step % stride or n > STREAM_MAX_N:
            raise InvalidArgumentError(
                f"the stream kernel takes osr | stride | step and n <= "
                f"{STREAM_MAX_N}, got stride {stride}, osr {osr}, step "
                f"{step}, n {n}")
        dev = ext_r.device
        lead = tuple(ext_r.shape[:-1])
        length = ext_r.shape[-1]
        plane = lead + (length,)
        sr = _checked(ext_r, "ext_r", torch.float32, plane, dev)
        si = _checked(ext_i, "ext_i", torch.float32, plane, dev)
        mr, mi = _down_chirp(params, dcr, dci, dev)
        mr = _checked(mr, "dcr", torch.float32, (n,), dev)
        mi = _checked(mi, "dci", torch.float32, (n,), dev)
        bsz = int(np.prod(lead)) if lead else 1
        if bsz * windows >= 2 ** 31:
            raise ValueError(f"{bsz * windows} windows exceed the kernel's "
                             "32-bit window indexing")
        idx = torch.empty(lead + (windows,), dtype=torch.int32, device=dev)
        pw = torch.empty(lead + (windows,), dtype=torch.float32, device=dev)
        pav = torch.empty(lead + (windows,), dtype=torch.float32, device=dev)
        if bsz == 0 or windows <= 0:
            return idx, pw, pav
        tw, bins = device_table(_fft_tables, n, device=dev)
        scale_db = float(np.float32(20.0 * np.log10(n)))
        lib = cuda_build.load()
        with torch.cuda.device(dev):
            err = lib.lora_stream_scan(
                sr.data_ptr(), si.data_ptr(), mr.data_ptr(), mi.data_ptr(),
                tw.data_ptr(), bins.data_ptr(), bsz, length, windows, stride,
                n, osr, scale_db, idx.data_ptr(), pw.data_ptr(),
                pav.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise RuntimeError(
                f"lora_stream_scan launch failed: cudaError_t {err}")
        count("launch.stream_scan")
        return idx, pw, pav

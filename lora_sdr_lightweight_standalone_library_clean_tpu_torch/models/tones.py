"""Pre-dechirped ("tones") demodulation path — golden-vector parity.

PyTorch port of ``lora_sdr_lightweight_standalone_library_clean_tpu/models/
tones.py``, the reference's legacy vector path ``lora_demodulate``
(``src/phy/LoRaDemod.cpp:50-197``): callers dechirp externally and this
function performs peak normalization, the 2-symbol CFO/timing estimate with
the explicit lowest-index tie-break (LoRaDemod.cpp:102-111), per-symbol CFO
derotation, windowing, detection, and sync-word nibble extraction.  This is
the path the reference perf harness times (tests/performance_test.cpp:
112-125).

The device of the input decides the detection path
(``ops/cuda_rx.py::rx_window_detect``): a CUDA tensor runs the fused RX
kernel (``rx_dense``/``rx_hybrid`` at osr == 1, ``rx_osr`` on the decimated
osr > 1 windows), a CPU tensor its plain version, the torch form of the JAX
package's jnp path (``tones.py:90-100,145-155``).
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.cuda_rx import rx_window_detect
from ..utils.config import LoraParams, Window
from ..utils.tensors import device_table
from .modem import TWO_PI, DemodResult, _estimate_core, window_table

__all__ = ["demodulate_tones"]


def _tones_mult(n: int, window: Window) -> tuple[np.ndarray, np.ndarray]:
    """The RX multiplier of the pre-dechirped path: (window or ones, 0)."""
    win = window_table(n, window)
    mr = np.ones(n, np.float32) if win is None else win
    return mr, np.zeros(n, np.float32)


def demodulate_tones(iq_r, iq_i, params: LoraParams,
                     normalize: bool = True) -> DemodResult:
    """Demodulate pre-dechirped samples (LoRaDemod.cpp:50-197).

    Matches the reference exactly, including:
     - peak normalization into [-1, 1] only when max(|I|,|Q|) > 1
       (LoRaDemod.cpp:60-78).
     - equal-power lowest-index tie-break during estimation
       (LoRaDemod.cpp:102-111).
     - sync-word extraction only when >= 2 symbols are present
       (LoRaDemod.cpp:166-193); with fewer symbols all detections are data.
    """
    n, step = params.n, params.step
    sample_count = iq_r.shape[-1]
    total = sample_count // step
    have_sync = total >= 2
    cut = total * step
    iq_r = iq_r[..., :cut].contiguous()
    iq_i = iq_i[..., :cut].contiguous()

    if normalize:
        # one reduction pass per plane for the peak (the inf-norm is
        # max |x| without a full-size |x| temporary); the scale multiplies
        # the (much smaller) estimator slice and symbol windows instead of
        # materializing a normalized copy of the whole stream
        inf = float("inf")
        max_amp = torch.maximum(
            torch.linalg.vector_norm(iq_r, ord=inf, dim=-1),
            torch.linalg.vector_norm(iq_i, ord=inf, dim=-1))
        scale = torch.where(max_amp > 1.0, 1.0 / max_amp,
                            torch.ones_like(max_amp))[..., None]
    else:
        scale = torch.ones(iq_r.shape[:-1] + (1,), dtype=torch.float32,
                           device=iq_r.device)

    est_syms = min(total, 2)
    est = _estimate_core(iq_r[..., : est_syms * step] * scale,
                         iq_i[..., : est_syms * step] * scale,
                         params, est_syms, tie_break_idx=True)
    t_off = torch.round(est.time_offset).to(torch.int32)
    rate = -float(TWO_PI) * est.cfo / float(np.float32(n))

    mr, mi = device_table(_tones_mult, n, params.window, device=iq_r.device)
    idx, power, power_avg = rx_window_detect(
        iq_r, iq_i, torch.clamp(t_off, -step, step), rate,
        scale[..., 0].contiguous(), mr, mi, params)
    if have_sync:
        sw0, sw1 = idx[..., 0], idx[..., 1]
        shift = params.sf - 4 if params.sf > 4 else 0
        sync = ((((sw0 >> shift) & 0xF) << 4) | ((sw1 >> shift) & 0xF))
        symbols = idx[..., 2:]
    else:
        sync = torch.zeros(idx.shape[:-1], dtype=torch.int32,
                           device=idx.device)
        symbols = idx
    return DemodResult(
        symbols=symbols.to(torch.int32),
        sync_word=sync.to(torch.uint8),
        cfo=est.cfo,
        time_offset=est.time_offset,
        power=power,
        power_avg=power_avg,
    )

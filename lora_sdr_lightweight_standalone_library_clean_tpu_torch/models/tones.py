"""Pre-dechirped ("tones") demodulation path — golden-vector parity.

PyTorch port of ``lora_sdr_lightweight_standalone_library_clean_tpu/models/
tones.py``, the reference's legacy vector path ``lora_demodulate``
(``src/phy/LoRaDemod.cpp:50-197``): callers dechirp externally and this
function performs peak normalization, the 2-symbol CFO/timing estimate with
the explicit lowest-index tie-break (LoRaDemod.cpp:102-111), per-symbol CFO
derotation, windowing, detection, and sync-word nibble extraction.  This is
the path the reference perf harness times (tests/performance_test.cpp:
112-125).

``backend`` chooses between the JAX package's two kernel routes, with its
values: ``"auto"`` and ``"pallas_rx"`` take the fused RX kernel
(``ops/cuda_rx.py::rx_window_detect``: ``rx_dense``/``rx_hybrid`` at
osr == 1, ``rx_osr`` on the decimated osr > 1 windows); ``"pallas"`` takes
the two-stage route, timing-shifted windows in torch and then the
rotate-detect kernel (``_rotate_detect``, ``ops/cuda_detect.py``, n <= 512
on the card).  The device of the input decides whether a route runs its
kernel (a CUDA tensor) or the kernel's plain version (a CPU tensor, the
torch form of the JAX package's jnp path, ``tones.py:90-100,145-155``).
The knob exists for parity with the JAX entry points' API and to keep the
rotate-detect kernel reachable; it is not a performance selection:
``"pallas_rx"`` is an alias of ``"auto"``, and ``"pallas"`` writes the
shifted windows out before the kernel reads them back.  It takes no further
values.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.cuda_detect import fused_rotate_detect
from ..ops.cuda_rx import rx_window_detect
from ..utils.config import LoraParams, Window
from ..utils.errors import InvalidArgumentError
from ..utils.spans import span, spanned
from ..utils.tensors import device_table
from .modem import (TWO_PI, DemodResult, _estimate_core,
                    _timing_shifted_windows, _peak_scale, window_table)

BACKENDS = ("auto", "pallas_rx", "pallas")

__all__ = ["demodulate_tones"]


def _tones_mult(n: int, window: Window) -> tuple[np.ndarray, np.ndarray]:
    """The RX multiplier of the pre-dechirped path: (window or ones, 0)."""
    win = window_table(n, window)
    mr = np.ones(n, np.float32) if win is None else win
    return mr, np.zeros(n, np.float32)


def _two_stage(backend: str) -> bool:
    """True for the two-stage route (``"pallas"``), False for the fused RX
    (``"auto"``, ``"pallas_rx"``); any other value raises."""
    if backend not in BACKENDS:
        raise InvalidArgumentError(
            f"backend {backend!r}: the port's routes are 'auto' and "
            "'pallas_rx' (the fused RX kernel) and 'pallas' (timing-shifted "
            "windows, then the rotate-detect kernel); a CPU tensor runs the "
            "plain version of either, so there is no 'jnp' route")
    return backend == "pallas"


@spanned("lora.rx.demod")
def demodulate_tones(iq_r, iq_i, params: LoraParams,
                     normalize: bool = True,
                     backend: str = "auto") -> DemodResult:
    """Demodulate pre-dechirped samples (LoRaDemod.cpp:50-197).

    Matches the reference exactly, including:
     - peak normalization into [-1, 1] only when max(|I|,|Q|) > 1
       (LoRaDemod.cpp:60-78).
     - equal-power lowest-index tie-break during estimation
       (LoRaDemod.cpp:102-111).
     - sync-word extraction only when >= 2 symbols are present
       (LoRaDemod.cpp:166-193); with fewer symbols all detections are data.

    ``backend``: ``"auto"``/``"pallas_rx"`` (the fused RX kernel) or
    ``"pallas"`` (the two-stage route); see the module docstring.

    Stages (spans under a profiler session): ``lora.rx.norm``,
    ``lora.rx.estimate``, ``lora.rx.detect`` inside ``lora.rx.demod``.
    """
    two_stage = _two_stage(backend)
    n, osr, step = params.n, params.osr, params.step
    sample_count = iq_r.shape[-1]
    total = sample_count // step
    have_sync = total >= 2
    cut = total * step

    with span("lora.rx.norm"):
        iq_r = iq_r[..., :cut].contiguous()
        iq_i = iq_i[..., :cut].contiguous()
        scale = _peak_scale(iq_r, iq_i, normalize)

    with span("lora.rx.estimate"):
        est_syms = min(total, 2)
        est = _estimate_core(iq_r[..., : est_syms * step] * scale,
                             iq_i[..., : est_syms * step] * scale,
                             params, est_syms, tie_break_idx=True)
        t_off = torch.round(est.time_offset).to(torch.int32)
        rate = -float(TWO_PI) * est.cfo / float(np.float32(n))

    with span("lora.rx.detect"):
        if two_stage:
            zr, zi = _timing_shifted_windows(iq_r, iq_i, t_off, total, step,
                                             osr, n)
            zr = zr * scale[..., None]
            zi = zi * scale[..., None]
            idx, power, power_avg = _rotate_detect(
                zr, zi, rate, _rotation_start(rate, t_off, total, params),
                params)
        else:
            mr, mi = device_table(_tones_mult, n, params.window,
                                  device=iq_r.device)
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


def _rotation_start(rate, t_off, total: int, params: LoraParams):
    """The CFO derotation phase of sample 0 of each symbol window,
    rate * (s*n + t_off/osr) (phy.cpp:218-225): (..., total)."""
    s_idx = torch.arange(total, dtype=torch.float32,
                         device=rate.device) * float(params.n)
    return rate[..., None] * (
        s_idx + t_off.to(torch.float32)[..., None] / float(params.osr))


def _rotate_detect(zr, zi, rate, start, params: LoraParams):
    """Window, then CFO-rotate and detect each symbol window through
    ``ops/cuda_detect.py::fused_rotate_detect`` (the rotate-detect kernel on
    a CUDA tensor, n <= 512; its plain version on a CPU tensor).  The
    window is applied before the rotation (the reference rotates first,
    phy.cpp:218-227: a float reordering that cannot change any detection,
    both orders scale each sample by the same two factors), as the JAX
    package's route does (``models/tones.py:119-144``).  Leading axes are
    flattened into the kernel's batch of packets."""
    n = params.n
    win = window_table(n, params.window)
    if win is not None:
        w = device_table(window_table, n, params.window, device=zr.device)
        zr = zr * w
        zi = zi * w
    lead = zr.shape[:-2]
    total = zr.shape[-2]
    idx, power, power_avg = fused_rotate_detect(
        zr.reshape(-1, total, n).contiguous(),
        zi.reshape(-1, total, n).contiguous(),
        rate.reshape(-1).contiguous(),
        start.reshape(-1, total).contiguous())
    return (idx.reshape(lead + (total,)), power.reshape(lead + (total,)),
            power_avg.reshape(lead + (total,)))

#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one GPU and check it.

Run from the root of a checkout, on a machine with one Hopper card:

    python3 chip_smoke.py

Phases (one line each; any failure raises and the exit code is nonzero):

1. environment: card name and power limit, torch/CUDA versions, compute
   capability 9.0, float32 matmuls in full precision (no TF32);
2. build: compile ``csrc/*.cu`` with nvcc (``utils/cuda_build.py``), one
   process per source, started together;
3. kernel vs plain on the card, 64 packets: the TX kernels against
   ``tx_tone_synth_ref`` and the RX kernels against
   ``rx_window_detect_ref`` at sf2..12 (dense kernels to sf9, the factored
   TX and the large-n RX above; at sf10-12 TX over the full tone range at
   BW125/250/500 with and without the folded down-chirp, RX with the
   multipliers ones, Hann and down-chirp x Hann); on 16 packets the osr > 1
   TX (sf9/BW250/osr2 and sf12/BW500/osr4 ungated, sf7/BW125/osr2 and
   sf8/BW125/osr4 gated, symbols over [0, 2n)), the decimated RX at sf5-12
   x osr 2, 4, the halo RX on the wide sf9/BW250/osr2 grid and the
   large-n RX on the wide 1024-, 8192- and 16384-point grids;
4. the sf7 slice at real size: sf7/BW125/CR4-5, 8192 packets of 32 bytes
   (the batch and payload of the JAX package's ``bench.py``), through
   ``encode -> modulate_dechirped -> demodulate_tones -> decode``, with
   SX1272 CRCs in every payload and 16 payloads altered after the CRC;
   checks the bytes, the CRC verdicts, the sync word, that both dense
   kernels ran, that the plain versions on the card and on the CPU give
   the same symbols; then each kernel against its plain version on the
   inputs the slice gave it (8192 x 66 rows/windows), and the RX kernel
   once more on that stream with AWGN;
5. the sf12 slice at full width: sf12/BW125/CR4-5, 256 packets of 32
   bytes (``bench.py``'s sf12 batch: 16,896 windows of 4,096 samples),
   the same checks through the factored TX and the large-n RX;
5A. the wide slice sf12/BW500/CR4-5/osr4 (``bench.py``'s
   ``sf12_bw500_osr4_wide``), 64 packets through ``encode ->
   modulate_dechirped -> demodulate_wide -> decode`` (4,224 windows of
   16,384 samples): the osr TX and the 16384-point RX, the same checks;
5B. the wide slice sf9/BW250/CR4-8/osr2 (``sf9_bw250_osr2_wide``), 1024
   packets (67,584 windows of 1,024): the osr TX and the 1024-point RX;
5C. the decimated slice sf7/BW125/CR4-5/osr2 (the osr-2 C-reference
   fixture's configuration), 4096 packets through ``demodulate_tones``:
   the gated osr TX and the decimated RX.  This receiver reads the last
   symbol's edge row at phase 0 (the reference's clamp), so the checks are
   every other symbol exact, the last one exact or one bin low, the CRC
   failing exactly where the bytes differ, and the kernels equal to the
   plain versions on the card and on the CPU;
6. full RX, ``modulate -> demodulate``, at sf7 (8192 packets), sf12 (256)
   and sf7/osr2 (4096): the kernel path against the plain versions on the
   card and the CPU plain path on 8 packets; then all eight C-reference
   fixtures (``tests/vectors``, osr 2 included) through ``demodulate``
   (the reference's own demod symbols) and ``dechirp ->
   demodulate_tones`` (``(encoded * bw_scale) mod n``) on the card;
7. timing (printed, not asserted): packets/s of every slice through the
   kernels and through the plain versions (and the sf12 full RX), and
   each kernel alone beside its plain version at each slice's shapes,
   with CUDA events, beside its bound (bytes over 3.35 TB/s or float32
   operations over 67 TFLOP/s, the larger).

Every slice and full-RX run sets the launch counts to 0 just before it
and reads them just after; a kernel of that path that did not launch
fails the run.
It ends with a JSON line of the kernels, the ``nvidia-smi`` name/power
line, and ``{"ok": true, "device": {...}}`` as the last line.  Without a
CUDA device, or outside a checkout, it exits nonzero and prints no result.
"""
from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

import lora_sdr_lightweight_standalone_library_clean_tpu_torch as lora
from lora_sdr_lightweight_standalone_library_clean_tpu_torch.models import (
    modem, tones)
from lora_sdr_lightweight_standalone_library_clean_tpu_torch.models.modem import (
    TWO_PI, _full_rx_mult)
from lora_sdr_lightweight_standalone_library_clean_tpu_torch.models.tones import (
    _tones_mult)
from lora_sdr_lightweight_standalone_library_clean_tpu_torch.ops import (
    cuda_rx, cuda_tx)
from lora_sdr_lightweight_standalone_library_clean_tpu_torch.ops.chirp import (
    _with_sync_prelude)
from lora_sdr_lightweight_standalone_library_clean_tpu_torch.utils import (
    cuda_build)
from lora_sdr_lightweight_standalone_library_clean_tpu_torch.utils.tensors import (
    device_table)

PKG = "lora_sdr_lightweight_standalone_library_clean_tpu_torch"
JAX_PKG = "lora_sdr_lightweight_standalone_library_clean_tpu"
PACKETS = 8192          # bench.py:513 batch at sf7
PACKETS_SF12 = 256      # bench.py:513 batch at sf12
PACKETS_A = 64          # wide sf12/BW500/osr4: 4,224 windows of 16,384
PACKETS_B = 1024        # wide sf9/BW250/osr2: 67,584 windows of 1,024
PACKETS_C = 4096        # decimated sf7/BW125/osr2: 270,336 windows of 128
PHASE3_PACKETS = 64     # packets per osr-1 case of phase 3
PHASE3_OSR = 16         # packets per osr > 1 / wide case of phase 3
PAYLOAD = 32            # bench.py:64 payload bytes -> 66 symbols
ALTERED = 16            # payloads changed after their CRC was appended
CPU_PACKETS = 8         # packets the CPU plain path re-runs (sf12, full RX)
TX_ATOL = 4e-6          # IQ, |kernel - plain| (tests/test_pallas.py:299)
RX_DB_ATOL = 0.05       # dB, FFT vs matmul DFT summation order
TIME_ATOL = 1e-3        # samples, time_offset card vs CPU
SIGMA = 0.03            # AWGN of the RX comparisons (tests/test_pallas.py)
SMALL_SFS = (2, 3, 4, 5, 6, 7, 8, 9)
LARGE_SFS = (10, 11, 12)
BWS = (125000, 250000, 500000)
OSR_TX = ((9, 250000, 2), (12, 500000, 4),      # dense / factored, ungated
          (7, 125000, 2), (8, 125000, 4))       # dense / factored, gated
OSR_SFS = (5, 6, 7, 8, 9, 10, 11, 12)
HALOS = ((1, 1), (1, 0), (0, 1))
MEM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12      # H100 SXM float32 outside the tensor cores
SEED = 7
VEC_DIR = Path(__file__).resolve().parent / "tests" / "vectors"
COUNTS = ((cuda_tx, "DENSE_LAUNCHES", "tx_dense"),
          (cuda_tx, "FACTORED_LAUNCHES", "tx_factored"),
          (cuda_tx, "OSR_LAUNCHES", "tx_osr"),
          (cuda_rx, "DENSE_LAUNCHES", "rx_dense"),
          (cuda_rx, "HYBRID_LAUNCHES", "rx_hybrid"),
          (cuda_rx, "OSR_LAUNCHES", "rx_osr"))
KERNELS = [name for _, _, name in COUNTS]


def _smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _sync():
    torch.cuda.synchronize()


def _time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device milliseconds per call of ``fn``, CUDA events."""
    for _ in range(warmup):
        fn()
    _sync()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    _sync()
    return start.elapsed_time(stop) / iters


def _abba(kernel_fn, plain_fn, iters: int = 10) -> tuple[float, float]:
    """Kernel and plain times in turns (plain, kernel, kernel, plain)."""
    p1 = _time_ms(plain_fn, iters)
    k1 = _time_ms(kernel_fn, iters)
    k2 = _time_ms(kernel_fn, iters)
    p2 = _time_ms(plain_fn, iters)
    return (k1 + k2) / 2, (p1 + p2) / 2


def _reset_counts() -> None:
    for mod, attr, _ in COUNTS:
        setattr(mod, attr, 0)
    cuda_tx.KERNEL_LAUNCHES = 0
    cuda_rx.KERNEL_LAUNCHES = 0


def _counts() -> dict:
    return {name: getattr(mod, attr) for mod, attr, name in COUNTS}


def _noisy_packets(p, count: int, rng, dev, raw: bool = False):
    """``count`` random 32-byte packets, modulated pre-dechirped (raw
    chirps with ``raw``) by the plain versions on the card (the TX kernel's
    plain version where a TX kernel applies, else the closed form), plus
    AWGN sigma 0.03 from numpy."""
    payload = rng.integers(0, 256, (count, PAYLOAD)).astype(np.uint8)
    syms = lora.encode(torch.as_tensor(payload, device=dev))
    with _plain_versions():
        modulate = lora.modulate if raw else lora.modulate_dechirped
        dr, di = modulate(syms, p)
    noise = rng.standard_normal((2,) + tuple(dr.shape)).astype(np.float32)
    noise = torch.as_tensor(noise * np.float32(SIGMA), device=dev)
    return (dr + noise[0]).contiguous(), (di + noise[1]).contiguous()


def phase_environment() -> str:
    assert torch.cuda.is_available(), "no CUDA device"
    smi = _smi()
    cap = torch.cuda.get_device_capability(0)
    assert cap == (9, 0), f"need compute capability 9.0, got {cap}"
    assert torch.backends.cuda.matmul.allow_tf32 is False, \
        "TF32 matmuls are on"
    assert torch.get_float32_matmul_precision() == "highest", \
        torch.get_float32_matmul_precision()
    print(f"phase 1 environment: {smi} | torch {torch.__version__} "
          f"cuda {torch.version.cuda} | capability {cap} | "
          f"allow_tf32=False, float32 matmul precision highest", flush=True)
    return smi


def phase_build() -> None:
    cuda_build.load()
    info = cuda_build.BUILD_INFO
    print(f"phase 2 build: {info['seconds']:.2f} s -> {info['path']}",
          flush=True)
    for line in info["log"].splitlines():
        if "registers" in line or "Compiling entry" in line:
            print(f"  ptxas: {line.strip()}")


def _rx_kernel_name(p, wide: bool = False, halo=(0, 0)) -> str:
    """The RX kernel ``rx_window_detect`` launches for this call."""
    if (p.osr > 1 and not wide) or tuple(halo) != (0, 0):
        return "rx_osr"
    ndft = p.step if wide else p.n
    return "rx_dense" if ndft <= cuda_rx.RX_DENSE_MAX_N else "rx_hybrid"


def _rx_compare(args, what, noise_db: bool = True, **kw) -> float:
    """RX kernel against its plain version on the same inputs: bins
    equal, dB within RX_DB_ATOL.  Returns the largest dB error checked."""
    gi_, gp, ga = cuda_rx.rx_window_detect(*args, **kw)
    wi_, wp, wa = cuda_rx.rx_window_detect_ref(*args, **kw)
    flips = int((gi_ != wi_).sum())
    assert flips == 0, (what, flips)
    err = float((gp - wp).abs().max())
    if noise_db:
        err = max(err, float((ga - wa).abs().max()))
    assert err <= RX_DB_ATOL, (what, err)
    return err


def _tx_compare(allsyms, p, what, amplitude=1.0, dechirp=True) -> float:
    """TX kernel against its plain version: |dIQ| within TX_ATOL."""
    gr, gi = cuda_tx.tx_tone_synth(allsyms, p, amplitude, dechirp=dechirp)
    wr, wi = cuda_tx.tx_tone_synth_ref(allsyms, p, amplitude,
                                       dechirp=dechirp)
    err = max(float((gr - wr).abs().max()), float((gi - wi).abs().max()))
    assert err <= TX_ATOL, (what, err)
    return err


def _tx_kernel_name(p) -> str:
    if p.osr > 1:
        return "tx_osr"
    return "tx_dense" if p.n <= cuda_tx.TX_DENSE_MAX_N else "tx_factored"


def _rx_mults(p, dev):
    """The RX multipliers of phase 3, each with whether it takes raw
    chirps: ones and Hann on the pre-dechirped stream (the tones path),
    down-chirp x Hann on raw chirps (the full RX)."""
    hann = lora.Window.HANN
    return {"ones": (device_table(_tones_mult, p.n, lora.Window.NONE,
                                  device=dev), False),
            "hann": (device_table(_tones_mult, p.n, hann, device=dev),
                     False),
            "downchirp x hann": (device_table(_full_rx_mult, p.sf,
                                              p.bw_scale, hann, device=dev),
                                 True)}


def _rx_case(p, count, rng, dev, raw: bool = False):
    """Phase 3's RX inputs: noisy packets, t_off with 0, +-step and
    osr + 1, rate ~ N(0, 1e-4), scale in [0.5, 1]."""
    step = p.step
    dr, di = _noisy_packets(p, count, rng, dev, raw)
    t_off = rng.integers(-step, step + 1, count).astype(np.int32)
    t_off[:4] = [0, step, -step, p.osr + 1]
    rate = (rng.standard_normal(count) * 1e-4).astype(np.float32)
    scale = rng.uniform(0.5, 1.0, count).astype(np.float32)
    return [dr, di] + [torch.as_tensor(a, device=dev)
                       for a in (t_off, rate, scale)]


def _rx_cases(p, count, mults, rng, dev) -> float:
    """Each multiplier of ``mults`` on its kind of stream (raw chirps or
    pre-dechirped): bins equal, dB within RX_DB_ATOL; the largest error."""
    err = 0.0
    cases = {raw: _rx_case(p, count, rng, dev, raw)
             for raw in sorted({raw for _, raw in mults.values()})}
    for label, ((mr, mi), raw) in mults.items():
        err = max(err, _rx_compare((*cases[raw], mr, mi, p),
                                   (p.sf, p.osr, label)))
    return err


def phase_kernel_vs_plain(dev, rng) -> dict:
    """Returns the largest error of each kernel: {name: err}."""
    err = {name: 0.0 for name in KERNELS}
    for sf in SMALL_SFS + LARGE_SFS:
        name = "tx_dense" if sf in SMALL_SFS else "tx_factored"
        for bw in (BWS if sf in LARGE_SFS else (125000,)):
            p = lora.LoraParams(sf=sf, bw=bw)
            if sf in SMALL_SFS:
                payload = rng.integers(
                    0, 256, (PHASE3_PACKETS, PAYLOAD)).astype(np.uint8)
                syms = lora.encode(torch.as_tensor(payload, device=dev))
            else:   # the full tone range: every digit-table row is used
                syms = torch.as_tensor(
                    rng.integers(0, p.n, (PHASE3_PACKETS, 2 * PAYLOAD)),
                    device=dev)
            allsyms = _with_sync_prelude(syms, p)
            for dechirp in (False, True):
                err[name] = max(err[name], _tx_compare(
                    allsyms, p, (sf, bw, dechirp), 0.75, dechirp))
    # #3: the osr > 1 TX over [0, 2n), so both wrap gates fire
    for sf, bw, osr in OSR_TX:
        p = lora.LoraParams(sf=sf, bw=bw, osr=osr)
        syms = torch.as_tensor(
            rng.integers(0, 2 * p.n, (PHASE3_OSR, 2 * PAYLOAD)), device=dev)
        allsyms = _with_sync_prelude(syms, p)
        for dechirp in (False, True):
            err["tx_osr"] = max(err["tx_osr"], _tx_compare(
                allsyms, p, (sf, bw, osr, dechirp), 0.75, dechirp))
    for sf in SMALL_SFS + LARGE_SFS:
        name = "rx_dense" if sf in SMALL_SFS else "rx_hybrid"
        p = lora.LoraParams(sf=sf)
        if sf in SMALL_SFS:
            mults = {"ones": (device_table(_tones_mult, p.n, p.window,
                                           device=dev), False)}
        else:
            mults = _rx_mults(p, dev)
        err[name] = max(err[name], _rx_cases(p, PHASE3_PACKETS, mults,
                                             rng, dev))
    # #6: decimated osr > 1 windows at sf5-12, osr 2 and 4
    for sf in OSR_SFS:
        for osr in (2, 4):
            p = lora.LoraParams(sf=sf, osr=osr)
            err["rx_osr"] = max(err["rx_osr"], _rx_cases(
                p, PHASE3_OSR, _rx_mults(p, dev), rng, dev))
    # #6's halo variant and #5 at 1024 (halo-free), 8192 and 16384 points:
    # the wide grids of sf9/BW250/osr2, sf11/BW500/osr4, sf12/BW500/osr4
    for sf, bw, osr, halos in ((9, 250000, 2, ((0, 0),) + HALOS),
                               (11, 500000, 4, ((0, 0),)),
                               (12, 500000, 4, ((0, 0),))):
        p = lora.LoraParams(sf=sf, bw=bw, osr=osr)
        case = _rx_case(p, PHASE3_OSR, rng, dev)
        mults = {w.value: device_table(modem._wide_mult, p.n, osr, w,
                                       device=dev)
                 for w in (lora.Window.NONE, lora.Window.HANN)}
        for halo in halos:
            name = _rx_kernel_name(p, True, halo)
            for label, (mr, mi) in mults.items():
                err[name] = max(err[name], _rx_compare(
                    (*case, mr, mi, p), (sf, osr, "wide", halo, label),
                    wide=True, halo=halo))
    _sync()
    print(f"phase 3 kernel vs plain, {PHASE3_PACKETS} packets: TX sf{SMALL_SFS[0]}-"
          f"{SMALL_SFS[-1]} dense max |dIQ| = {err['tx_dense']:.3g}, "
          f"sf{LARGE_SFS[0]}-{LARGE_SFS[-1]} factored (BW125/250/500, full "
          f"tone range) max |dIQ| = {err['tx_factored']:.3g}, dechirp F/T; "
          f"osr TX ({PHASE3_OSR} packets; sf/BW/osr "
          f"{', '.join(f'{a}/{b // 1000}/{c}' for a, b, c in OSR_TX)}, "
          f"[0, 2n)) max |dIQ| = {err['tx_osr']:.3g} (tol {TX_ATOL}); RX "
          f"bins equal, sf{SMALL_SFS[0]}-{SMALL_SFS[-1]} dense max |d dB| = "
          f"{err['rx_dense']:.3g}, sf{LARGE_SFS[0]}-{LARGE_SFS[-1]} large-n "
          f"(ones, Hann; down-chirp x Hann on raw chirps) and wide "
          f"1024/8192/16384 points "
          f"max |d dB| = {err['rx_hybrid']:.3g}, decimated sf"
          f"{OSR_SFS[0]}-{OSR_SFS[-1]} x osr 2, 4 and wide halos "
          f"{', '.join(map(str, HALOS))} max |d dB| = {err['rx_osr']:.3g} "
          f"(tol {RX_DB_ATOL})", flush=True)
    return err


def _payloads(p, count: int, dev, rng):
    """``count`` payloads whose last two bytes are the SX1272 CRC of bytes
    2..k-3 (the rule decode checks), then ALTERED of them altered."""
    payload = torch.as_tensor(
        rng.integers(0, 256, (count, PAYLOAD)).astype(np.uint8), device=dev)
    crc = lora.crc_sx1272(payload[:, 2:PAYLOAD - 2])
    payload[:, PAYLOAD - 2] = (crc & 0xFF).to(torch.uint8)
    payload[:, PAYLOAD - 1] = (crc >> 8).to(torch.uint8)
    bad = np.sort(rng.choice(count, ALTERED, replace=False))
    pos = rng.integers(2, PAYLOAD - 2, ALTERED)
    flip = rng.integers(1, 256, ALTERED).astype(np.uint8)
    bad_t = torch.as_tensor(bad, device=dev)
    pos_t = torch.as_tensor(pos, device=dev)
    payload[bad_t, pos_t] ^= torch.as_tensor(flip, device=dev)
    return payload, bad


def _is_wide(p) -> bool:
    """BW250/500 with osr >= bw_scale: the receiver that keeps every
    symbol bit is ``demodulate_wide``."""
    return p.bw_scale > 1 and p.osr >= p.bw_scale


def _receiver(p):
    return lora.demodulate_wide if _is_wide(p) else lora.demodulate_tones


def _pipeline(payload, p):
    syms = lora.encode(payload)
    dr, di = lora.modulate_dechirped(syms, p)
    res = _receiver(p)(dr, di, p)
    dec, crc_ok = lora.decode(res.symbols)
    return res, dec, crc_ok


def _full_rx(payload, p):
    re, im = lora.modulate(lora.encode(payload), p)
    return lora.demodulate(re, im, p)


@contextlib.contextmanager
def _plain_versions():
    """Route the entry points through the kernels' plain versions (which
    count no launches), so the same pipeline runs without the kernels."""
    saved = (cuda_tx.tx_tone_synth, tones.rx_window_detect,
             modem.rx_window_detect)
    cuda_tx.tx_tone_synth = cuda_tx.tx_tone_synth_ref
    tones.rx_window_detect = cuda_rx.rx_window_detect_ref
    modem.rx_window_detect = cuda_rx.rx_window_detect_ref
    try:
        yield
    finally:
        (cuda_tx.tx_tone_synth, tones.rx_window_detect,
         modem.rx_window_detect) = saved


def _plain(fn, payload, p):
    with _plain_versions():
        return fn(payload, p)


def _rx_args(dr, di, res, p):
    """The RX kernel's inputs as ``demodulate_tones`` (or, on the wide
    grid, ``demodulate_wide``) forms them from the stream and its
    estimate: (args, keywords)."""
    inf = float("inf")
    max_amp = torch.maximum(torch.linalg.vector_norm(dr, ord=inf, dim=-1),
                            torch.linalg.vector_norm(di, ord=inf, dim=-1))
    scale = torch.where(max_amp > 1.0, 1.0 / max_amp,
                        torch.ones_like(max_amp)).contiguous()
    t_off = torch.clamp(torch.round(res.time_offset).to(torch.int32),
                        -p.step, p.step)
    wide = _is_wide(p)
    if wide:
        rate = -float(TWO_PI) * res.cfo / float(np.float32(p.n * p.osr))
        mr, mi = device_table(modem._wide_mult, p.n, p.osr, p.window,
                              device=dr.device)
    else:
        rate = -float(TWO_PI) * res.cfo / float(np.float32(p.n))
        mr, mi = device_table(_tones_mult, p.n, p.window, device=dr.device)
    return (dr, di, t_off, rate.contiguous(), scale, mr, mi, p), \
        {"wide": wide}


def _full_size_kernel_vs_plain(payload, res, p):
    """Each kernel against its plain version at the slice's shapes: TX on
    the slice's symbol rows, RX on the stream and estimate the slice gave
    it (noise-free, where the noise dB is a rounding floor and is not
    compared) and on that stream with AWGN."""
    allsyms = _with_sync_prelude(lora.encode(payload), p)
    tx_err = _tx_compare(allsyms, p, ("full-size TX", p.sf))
    gr, gi = cuda_tx.tx_tone_synth(allsyms, p, dechirp=True)
    args, kw = _rx_args(gr, gi, res, p)
    rx_err = _rx_compare(args, ("full-size RX", p.sf), noise_db=False, **kw)
    gen = torch.Generator(device=gr.device).manual_seed(SEED)
    nr = gr + SIGMA * torch.randn(gr.shape, generator=gen, device=gr.device)
    ni = gi + SIGMA * torch.randn(gi.shape, generator=gen, device=gi.device)
    rx_err = max(rx_err, _rx_compare((nr, ni) + args[2:],
                                     ("full-size RX with AWGN", p.sf), **kw))
    del nr, ni
    _sync()
    return tx_err, rx_err, allsyms, (args, kw)


def _decimated_edge_check(payload, res, p) -> np.ndarray:
    """The decimated osr > 1 receiver on a clean stream: every symbol is
    (sent * bw_scale) mod n except the last, which is that or one bin
    lower.  The estimate puts the timing at 1 sample, and the last row
    (the edge clamp for t > 0) reads its unshifted samples at phase 0, as
    the JAX package's kernel and the reference do (``_shifted_windows``,
    phy.cpp:209-216).  Returns which packets lost their last symbol."""
    want = lora.encode(payload) * p.bw_scale % p.n
    got = res.symbols
    assert bool(torch.equal(got[:, :-1], want[:, :-1])), \
        int((got[:, :-1] != want[:, :-1]).sum())
    low = (want[:, -1] - got[:, -1]) % p.n
    assert bool(((low == 0) | (low == 1)).all()), low.unique()
    return (low == 1).cpu().numpy()


def _describe(p) -> str:
    return (f"sf{p.sf}/BW{p.bw // 1000}/CR{p.cr.replace('/', '-')}/"
            f"osr{p.osr}")


def phase_slice(dev, rng, phase, p, count: int, cpu_count: int):
    """The slice at real size through its TX and RX kernels, checked."""
    kernels = (_tx_kernel_name(p), _rx_kernel_name(p, _is_wide(p)))
    payload, bad = _payloads(p, count, dev, rng)
    _sync()
    _reset_counts()
    t0 = time.perf_counter()
    res, dec, crc_ok = _pipeline(payload, p)
    _sync()
    seconds = time.perf_counter() - t0
    launches = _counts()
    assert all(launches[k] > 0 for k in kernels), launches

    assert tuple(res.symbols.shape) == (count, 2 * PAYLOAD)
    assert bool(torch.isfinite(res.power).all()), "non-finite power"
    assert bool(torch.isfinite(res.power_avg).all()), "non-finite noise"
    want_ok = np.ones(count, bool)
    want_ok[bad] = False
    got_ok = crc_ok.cpu().numpy()
    exact = (dec == payload).all(dim=-1).cpu().numpy()
    if p.osr == 1 or _is_wide(p):
        assert exact.all(), int((~exact).sum())
        assert np.array_equal(got_ok, want_ok), np.nonzero(got_ok != want_ok)
        verdict = "decoded exactly, crc_ok False on exactly the altered"
    else:
        lost = _decimated_edge_check(payload, res, p)
        assert (exact | lost).all(), np.nonzero(~(exact | lost))
        assert not got_ok[bad].any() and not (got_ok & ~exact).any()
        assert np.array_equal(got_ok, want_ok & exact)
        verdict = (f"every symbol but the last exact, the last one bin low "
                   f"in {int(lost.sum())} packets (the estimate's t = 1 "
                   f"reads the edge row at phase 0, as the JAX package and "
                   f"the reference do), {int(exact.sum())} decode exactly, "
                   f"crc_ok True on exactly those not altered")
    assert bool((res.sync_word == 0x12).all()), "sync word"

    plain, pdec, pok = _plain(_pipeline, payload, p)
    assert bool(torch.equal(plain.symbols, res.symbols)), \
        int((plain.symbols != res.symbols).sum())
    assert bool(torch.equal(pdec, dec)) and bool(torch.equal(pok, crc_ok))
    # the plain path on the CPU agrees on a small slice of the batch
    cpu_res, _, _ = _pipeline(payload[:cpu_count].cpu(), p)
    assert torch.equal(cpu_res.symbols, res.symbols[:cpu_count].cpu())
    tx_err, rx_err, allsyms, rx_call = _full_size_kernel_vs_plain(
        payload, res, p)
    rows = count * (2 * PAYLOAD + 2)
    iq_mb = 2 * 4 * rows * p.step / 1e6
    print(f"phase {phase} slice: {_describe(p)} through "
          f"{_receiver(p).__name__}, {count} packets x {PAYLOAD} B "
          f"({iq_mb:.0f} MB IQ): {verdict} ({ALTERED}), sync 0x12, plain path "
          f"on the card (all) and CPU ({cpu_count}) agree; launches "
          f"{kernels[0]}={launches[kernels[0]]} "
          f"{kernels[1]}={launches[kernels[1]]}; first run {seconds:.3f} s; "
          f"at {count} x {2 * PAYLOAD + 2}: TX max |dIQ| = {tx_err:.3g} "
          f"(tol {TX_ATOL}), RX bins equal, max |d dB| = {rx_err:.3g} "
          f"(tol {RX_DB_ATOL}; noise-free and with AWGN sigma {SIGMA})",
          flush=True)
    return {"p": p, "payload": payload, "launches": launches,
            "kernels": kernels, "allsyms": allsyms, "rx_call": rx_call,
            "err": {kernels[0]: tx_err, kernels[1]: rx_err}}


def _fixture_checks(dev) -> list[str]:
    """Every C-reference fixture (osr 1 and osr 2) on the card:
    ``demodulate`` gives the reference's own demod symbols, ``dechirp ->
    demodulate_tones`` gives (encoded * bw_scale) mod n.  The reference's
    full RX cannot decode its own modulation (PARITY.md defect 1): symbol
    parity, not bytes."""
    names = []
    for path in sorted(VEC_DIR.glob("ref_sf*.npz")):
        d = np.load(path)
        p = lora.LoraParams(sf=int(d["sf"]), bw=int(d["bw"]),
                            osr=int(d["osr"]), window=str(d["window"]))
        rr, ri = lora.from_complex(d["iq"][None], device=dev)
        _reset_counts()
        res = lora.demodulate(rr, ri, p)
        mine = res.symbols.cpu().numpy()[0]
        assert np.array_equal(mine, d["demod"][: len(mine)]), path.stem
        tres = lora.demodulate_tones(*lora.dechirp(rr, ri, p), p)
        nsym = d["iq"].size // p.step - 2
        want = (d["encoded"][:nsym].astype(np.int64) * p.bw_scale) % p.n
        assert np.array_equal(tres.symbols.cpu().numpy()[0], want), path.stem
        assert _counts()[_rx_kernel_name(p)] == 2, (path.stem, _counts())
        names.append(path.stem)
    assert len(names) == 8, names
    return names


FULL_RX = ((lora.LoraParams(sf=7, bw=125000, cr="4/5"), PACKETS),
           (lora.LoraParams(sf=12, bw=125000, cr="4/5"), PACKETS_SF12),
           (lora.LoraParams(sf=7, bw=125000, cr="4/5", osr=2), PACKETS_C))


def phase_full_rx(dev, rng):
    """``modulate -> demodulate`` at sf7, sf12 and sf7/osr2 through the
    kernels, against the plain versions on the card and the CPU plain
    path; then the fixtures."""
    out, parts = {}, []
    launches_all = {name: 0 for name in KERNELS}
    for p, count in FULL_RX:
        kernels = (_tx_kernel_name(p), _rx_kernel_name(p))
        payload = torch.as_tensor(
            rng.integers(0, 256, (count, PAYLOAD)).astype(np.uint8),
            device=dev)
        _sync()
        _reset_counts()
        res = _full_rx(payload, p)
        _sync()
        launches = _counts()
        assert all(launches[k] > 0 for k in kernels), launches
        for k in KERNELS:
            launches_all[k] += launches[k]
        assert tuple(res.symbols.shape) == (count, 2 * PAYLOAD)
        assert bool(torch.isfinite(res.power).all()), "non-finite power"
        plain = _plain(_full_rx, payload, p)
        assert bool(torch.equal(plain.symbols, res.symbols)), \
            int((plain.symbols != res.symbols).sum())
        assert bool(torch.equal(plain.sync_word, res.sync_word))
        cpu = _full_rx(payload[:CPU_PACKETS].cpu(), p)
        assert torch.equal(cpu.symbols, res.symbols[:CPU_PACKETS].cpu())
        assert torch.equal(cpu.sync_word, res.sync_word[:CPU_PACKETS].cpu())
        dt = float((cpu.time_offset
                    - res.time_offset[:CPU_PACKETS].cpu()).abs().max())
        assert dt <= TIME_ATOL, (_describe(p), dt)
        out[(p.sf, p.osr)] = payload
        parts.append(f"{_describe(p)} {count} packets: kernels "
                     f"({kernels[0]}={launches[kernels[0]]}, {kernels[1]}="
                     f"{launches[kernels[1]]}) = plain on the card, = CPU "
                     f"on {CPU_PACKETS} (|d time_offset| {dt:.3g})")
    names = _fixture_checks(dev)
    print(f"phase 6 full RX: {'; '.join(parts)}; fixtures "
          f"{', '.join(names)}: demodulate = reference demod, tones path = "
          f"(encoded * bw_scale) mod n, on the card", flush=True)
    return out, launches_all


def _bound(nbytes: float, ops: float) -> tuple[float, str]:
    """The least time the card could take for the work, in ms: bytes over
    the memory rate or operations over the float32 rate, the larger."""
    t_bytes = nbytes / MEM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _tx_bound(allsyms, p) -> tuple[float, str]:
    """TX: each output sample stored once (8 B), each symbol and table
    entry read once; the complex products per sample the kernel's form
    needs (6 flops each: tone digits, multiplier, and one per wrap gate
    this run's symbols pass; 2 for the osr-1 row sign)."""
    rows = allsyms.numel()
    samples = rows * p.step
    n, osr, bs = p.n, p.osr, p.bw_scale
    if osr == 1:
        q = n
        per = (0 if n <= cuda_tx.TX_DENSE_MAX_N else 12) + 2 * (bs % 2)
        extra = 0 if n <= cuda_tx.TX_DENSE_MAX_N else 2 * n * 4
    else:
        q = n * osr // bs
        per = 6 if q <= cuda_tx.TX_DENSE_MAX_N else 12
        period = cuda_tx._carry_period(p.sf, bs, osr)
        extra = 2 * q * 4 + 2 * period * bs * q * 4
    if q <= cuda_tx.TX_DENSE_MAX_N:
        tables = 2 * q * q * 4
    else:
        tables = 2 * (q // 128) ** 2 * 4 + 2 * q * 128 * 4
    ops = samples * per
    if osr > 1 and bs % osr:
        sym = allsyms.reshape(-1, 1).to(torch.int64)
        k = torch.arange(bs, device=sym.device) * q
        thr1 = n * osr - sym * osr - k
        passed = sum(torch.clamp(q - t, 0, q).sum() for t in
                     (thr1, thr1 + n * osr))
        ops += 6 * int(passed)
    return _bound(samples * 8 + rows * 4 + tables + extra, ops)


def _rx_bound(args, kw) -> tuple[float, str]:
    """RX: the whole stream read once (8 B a sample; a strided osr > 1 read
    still moves every sector), 12 B per window out, the per-packet scalars,
    multiplier and twiddles once; per detected sample the scale, phase,
    rotation and multiplier products (16 flops) and its sine and cosine
    (2), then 5 n log2 n for the FFT and 5 per bin for |X|^2, the sum and
    the first max."""
    dr, p = args[0], args[-1]
    ndft = p.step if kw.get("wide") else p.n
    h0, h1 = kw.get("halo", (0, 0))
    packets = dr.numel() // dr.shape[-1]
    windows = packets * (dr.shape[-1] // p.step - h0 - h1)
    nbytes = dr.numel() * 8 + packets * 12 + ndft * 12 + windows * 12
    ops = windows * ndft * (18 + 5 + 5 * np.log2(ndft))
    return _bound(nbytes, ops)


def phase_timing(slices, full_rx, smi):
    """Packets/s of each slice through the kernels and the plain versions,
    and each kernel alone beside its plain version at the slice's shapes:
    {(kernel, slice label): (ms, plain ms, bound ms, bound by)}."""
    times = {}
    lines = []
    for label, sl in slices.items():
        p, payload, allsyms = sl["p"], sl["payload"], sl["allsyms"]
        (rx_args, rx_kw), (tx, rx) = sl["rx_call"], sl["kernels"]
        count = payload.shape[0]
        pipe_ms, pipe_plain_ms = _abba(lambda: _pipeline(payload, p),
                                       lambda: _plain(_pipeline, payload, p),
                                       iters=5)
        times[tx, label] = _abba(
            lambda: cuda_tx.tx_tone_synth(allsyms, p, dechirp=True),
            lambda: cuda_tx.tx_tone_synth_ref(allsyms, p, dechirp=True)) \
            + _tx_bound(allsyms, p)
        times[rx, label] = _abba(
            lambda: cuda_rx.rx_window_detect(*rx_args, **rx_kw),
            lambda: cuda_rx.rx_window_detect_ref(*rx_args, **rx_kw)) \
            + _rx_bound(rx_args, rx_kw)
        line = (f"{label} {_describe(p)} slice "
                f"{count / (pipe_ms / 1e3):,.0f} packets/s "
                f"({pipe_ms:.3f} ms / {count} packets) through the kernels, "
                f"{count / (pipe_plain_ms / 1e3):,.0f} packets/s "
                f"({pipe_plain_ms:.3f} ms) through the plain versions")
        if label == "sf12":
            payload = full_rx[12, 1]
            fr_ms, fr_plain_ms = _abba(lambda: _full_rx(payload, p),
                                       lambda: _plain(_full_rx, payload, p),
                                       iters=5)
            line += (f"; sf12 full RX {count / (fr_ms / 1e3):,.0f} packets/s "
                     f"({fr_ms:.3f} ms) vs plain "
                     f"{count / (fr_plain_ms / 1e3):,.0f} "
                     f"({fr_plain_ms:.3f} ms)")
        for name in (tx, rx):
            ms, plain_ms, bound_ms, _ = times[name, label]
            line += (f"; {name} {ms:.4f} ms vs plain {plain_ms:.4f} ms "
                     f"(bound {bound_ms:.4f} ms)")
        lines.append(line)
    print(f"phase 7 timing [{smi}]: " + " | ".join(lines), flush=True)
    return times


# Each kernel's line entry: the slice whose shapes it is timed at, and the
# TPU kernel it replaces.
KERNEL_LINE = (
    ("tx_dense", "sf7", "ops/pallas_tx.py:68"),
    ("tx_factored", "sf12", "ops/pallas_tx.py:177"),
    ("tx_osr", "A", "ops/pallas_tx.py:296"),
    ("rx_dense", "sf7", "ops/pallas_rx.py:508"),
    ("rx_hybrid", "sf12",
     "ops/pallas_rx.py:508 (hybrid DFT form, _dft_mag_argmax :330-397)"),
    ("rx_osr", "C",
     "ops/pallas_rx.py:508 (padded/slab osr > 1 form :577-594 and halo "
     "variant, _shifted_windows :413-441)"),
)


def run_phases(dev, rng, smi) -> list[dict]:
    """Phases 3-7; returns the kernels' line entries."""
    err = phase_kernel_vs_plain(dev, rng)
    slices = {}
    for phase, label, p, count, cpu_count in (
            (4, "sf7", lora.LoraParams(sf=7, bw=125000, cr="4/5"),
             PACKETS, 64),
            (5, "sf12", lora.LoraParams(sf=12, bw=125000, cr="4/5"),
             PACKETS_SF12, CPU_PACKETS),
            ("5A", "A", lora.LoraParams(sf=12, bw=500000, cr="4/5", osr=4),
             PACKETS_A, CPU_PACKETS),
            ("5B", "B", lora.LoraParams(sf=9, bw=250000, cr="4/8", osr=2),
             PACKETS_B, CPU_PACKETS),
            ("5C", "C", lora.LoraParams(sf=7, bw=125000, cr="4/5", osr=2),
             PACKETS_C, CPU_PACKETS)):
        slices[label] = phase_slice(dev, rng, phase, p, count, cpu_count)
    full_rx, launches = phase_full_rx(dev, rng)
    times = phase_timing(slices, full_rx, smi)
    for sl in slices.values():
        for name in KERNELS:
            launches[name] += sl["launches"][name]
        for name, e in sl["err"].items():
            err[name] = max(err[name], e)
    kernels = []
    for name, label, replaces in KERNEL_LINE:
        ms, plain_ms, bound_ms, bound_by = times[name, label]
        assert launches[name] > 0, (name, launches)
        entry = {"name": name, "route": "cuda",
                 "source": f"{PKG}/csrc/{name}.cu",
                 "replaces": f"{JAX_PKG}/{replaces}",
                 "launches": launches[name], "max_abs_err": err[name],
                 "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                 "bound_by": bound_by, "library_ms": None,
                 "timed_at": label}
        if name == "rx_hybrid":     # the wide sf12/BW500/osr4 grid
            ms, plain_ms, bound_ms, bound_by = times[name, "A"]
            entry["at_16384"] = {"ms": ms, "plain_ms": plain_ms,
                                 "bound_ms": bound_ms, "bound_by": bound_by}
        kernels.append(entry)
    return kernels


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "needs one CUDA card", file=sys.stderr)
        return 1
    rng = np.random.default_rng(SEED)
    dev = torch.device("cuda", 0)
    smi = phase_environment()
    phase_build()
    kernels = run_phases(dev, rng, smi)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one GPU and check it.

Run from the root of a checkout, on a machine with one Hopper card:

    python3 chip_smoke.py

Phases (one line each; any failure raises and the exit code is nonzero):

1. environment: card name and power limit, torch/CUDA versions, compute
   capability 9.0, float32 matmuls in full precision (no TF32);
2. build: compile ``csrc/*.cu`` with nvcc (``utils/cuda_build.py``), one
   process per source, started together; print each entry function's
   registers, spills and stack from ptxas's ``-v`` report, and fail if an
   RX kernel instance (``rx_dense_kernel``, ``rx_hybrid_kernel``) spills;
3. kernel vs plain on the card, 64 packets: the TX kernels against
   ``tx_tone_synth_ref`` and the RX kernels against
   ``rx_window_detect_ref`` at sf2..12 (dense kernels to sf9, the factored
   TX and the large-n RX above; at sf10-12 TX over the full tone range at
   BW125/250/500 with and without the folded down-chirp, RX with the
   multipliers ones, Hann and down-chirp x Hann); on 16 packets the osr > 1
   TX (sf9/BW250/osr2 and sf12/BW500/osr4 ungated, sf7/BW125/osr2 and
   sf8/BW125/osr4 gated, symbols over [0, 2n)), the decimated RX at sf5-12
   x osr 2, 4, the halo RX on the wide sf9/BW250/osr2 grid and the
   large-n RX on the wide 1024-, 8192- and 16384-point grids; the
   streaming scan (#7) against ``stream_window_detect_ref`` at sf5-12 x
   stride step/1, step/2, step/4 x osr 1, 2, 4 on short noisy streams
   holding a packet and on a (2, 3) batch of streams, and the
   rotate-detect kernel (#8) against ``fused_rotate_detect_ref`` at sf2-9
   on tones with |cfo| up to half a bin, windowed by ones and by Hann;
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
5S. the streaming receiver ``receive_stream`` at full size: three
   continuous streams of 71.3 M complex samples (570 MB), each holding
   packets of 32 bytes (SX1272 CRCs, 16 altered after the CRC) at
   k*(packet + 2 symbols) + u_k, u_k uniform in [0, step), with AWGN
   sigma 0.05 per plane on unit chirps (``bench.py:345``), recovered in
   one call with ``max_packets`` the packet count: S7 sf7/BW125/CR4-5,
   8192 packets, stride 32 (#7 at n = 128, then ``rx_dense``); S12
   sf12/BW125/CR4-5, 256 packets, stride 1024 (#7 at n = 4096, then
   ``rx_hybrid``); SW wide sf9/BW250/CR4-8/osr2, 1024 packets, stride 128
   (#7 at n = 512 with stride-2 reads, then ``demodulate_wide``).  Checks:
   every packet found once at its planted start, bytes, CRC verdicts and
   sync words exact, #7 launched and, on the call the path made, equal to
   its plain version (bins on every clear window, dB within 0.05), the
   kernel path equal to the plain path
   on the card (whole stream) and to the CPU plain path on a prefix that
   holds 8 packets, and on S7 the first 64 packets fed in chunks of
   65,536 samples with carried state equal to the one call;
6. full RX, ``modulate -> demodulate``, at sf7 (8192 packets), sf12 (256)
   and sf7/osr2 (4096): the kernel path against the plain versions on the
   card and the CPU plain path on 8 packets; then all eight C-reference
   fixtures (``tests/vectors``, osr 2 included) through ``demodulate``
   (the reference's own demod symbols) and ``dechirp ->
   demodulate_tones`` (``(encoded * bw_scale) mod n``) on the card;
6D. the two-stage detect route, ``backend="pallas"``: ``demodulate_tones``
   on phase 4's 8192 sf7 packets and phase 5C's 4096 sf7/osr2 packets,
   ``demodulate`` on phase 6's 8192 sf7 packets and on the osr-1
   C-reference fixtures with n <= 512: the rotate-detect kernel launched
   and the fused RX did not, symbols, sync words, CFO and timing equal to
   the ``auto`` route's, dB within 0.05; each rotate-detect call of the
   route against its plain version on the same inputs (bins on every row,
   dB within 0.05);
7. timing (printed, not asserted): packets/s of every slice through the
   kernels and through the plain versions (and the sf12 full RX), packets/s
   and Msamples/s of every stream slice, and each kernel alone beside its
   plain version at each slice's shapes, with CUDA events, beside its
   bound (bytes over 3.35 TB/s or float32 operations over 67 TFLOP/s, the
   larger); beside ``rx_hybrid`` at sf12 and A and ``stream_scan`` at S7
   and S12, ``torch.fft.fft`` alone over the same windows already
   materialised as complex64 (the FFT step only, a yardstick the port
   never calls).

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
import re
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
    cuda_detect, cuda_rx, cuda_stream, cuda_tx)
from lora_sdr_lightweight_standalone_library_clean_tpu_torch.ops.chirp import (
    _with_sync_prelude)
from lora_sdr_lightweight_standalone_library_clean_tpu_torch.parallel import (
    streaming)
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
STREAM_SFS = (5, 6, 7, 8, 9, 10, 11, 12)   # phase 3's #7 cases
STREAM_SYMBOLS = 21     # symbols per phase-3 stream
STREAM_SIGMA = 0.05     # AWGN of the stream slices (bench.py:345)
STREAM_CHUNK = 65536    # the streaming runner's default chunk
STREAM_CHUNK_PACKETS = 64
DETECT_ROWS = (16, 10)  # phase 3's #8 cases: packets x symbols
MEM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12      # H100 SXM float32 outside the tensor cores
SEED = 7
VEC_DIR = Path(__file__).resolve().parent / "tests" / "vectors"
COUNTS = ((cuda_tx, "DENSE_LAUNCHES", "tx_dense"),
          (cuda_tx, "FACTORED_LAUNCHES", "tx_factored"),
          (cuda_tx, "OSR_LAUNCHES", "tx_osr"),
          (cuda_rx, "DENSE_LAUNCHES", "rx_dense"),
          (cuda_rx, "HYBRID_LAUNCHES", "rx_hybrid"),
          (cuda_rx, "OSR_LAUNCHES", "rx_osr"),
          (cuda_stream, "STREAM_LAUNCHES", "stream_scan"),
          (cuda_detect, "DETECT_LAUNCHES", "rotate_detect"))
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
    for mod in (cuda_tx, cuda_rx, cuda_stream, cuda_detect):
        mod.KERNEL_LAUNCHES = 0


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


def _kernel_label(mangled: str) -> str:
    """``rx_hybrid_kernel<4096, StreamReader>`` from a mangled RX kernel
    instance name, the bare kernel name from another one."""
    m = re.search(r"(rx_[a-z]+_kernel)ILi(\d+)EN7lora_rx(\d+)", mangled)
    if m:
        reader = mangled[m.end():m.end() + int(m.group(3))]
        return f"{m.group(1)}<{m.group(2)}, {reader}>"
    m = re.search(r"[a-z]+(?:_[a-z]+)*_kernel", mangled)
    return m.group(0) if m else mangled


def _ptxas_report(log: str) -> list[tuple]:
    """(kernel, registers, spill stores, spill loads, stack bytes) of each
    entry function in nvcc's -Xptxas -v report."""
    rows, entry, props, spill = [], None, None, (0, 0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry, spill = m.group(1), (0, 0, 0)
            continue
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            props = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and props == entry:
            spill = tuple(int(v) for v in m.groups())
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            rows.append((_kernel_label(entry), int(m.group(1)), spill[1],
                         spill[2], spill[0]))
            entry = None
    return rows


def phase_build() -> None:
    """Build the kernels; print each entry function's registers and
    spills, and fail if an RX kernel instance spills."""
    cuda_build.load()
    info = cuda_build.BUILD_INFO
    print(f"phase 2 build: {info['seconds']:.2f} s -> {info['path']}",
          flush=True)
    rows = _ptxas_report(info["log"])
    for name, regs, stores, loads, stack in rows:
        print(f"  ptxas: {name}: {regs} registers, {stores} B spill stores, "
              f"{loads} B spill loads, {stack} B stack")
    rx = [r for r in rows if r[0].startswith("rx_")]
    # a fresh build reports every RX instance: 4 readers x 8 dense sizes,
    # 3 readers x 5 hybrid sizes (a cached library has no report)
    assert not info["log"] or len(rx) == 4 * 8 + 3 * 5, len(rx)
    spilled = [r[0] for r in rx if r[2] or r[3]]
    assert not spilled, f"RX kernel instances spill: {spilled}"


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


def _packet_stream(p, symbols: int, rng, dev, lead=()):
    """AWGN (sigma 0.05) streams of ``symbols`` symbols, each holding one
    32-byte packet (modulated by the plain versions) from an offset in
    [0, step/8) on the phase-0 decimation grid, so that windows near it
    have a clear peak at every stride (off that grid the tones fall
    between bins)."""
    length = symbols * p.step
    noise = rng.standard_normal((2,) + lead + (length,)).astype(np.float32)
    sr, si = torch.as_tensor(noise * np.float32(STREAM_SIGMA), device=dev)
    payload = rng.integers(0, 256, (1, PAYLOAD)).astype(np.uint8)
    with _plain_versions():
        re, im = lora.modulate(lora.encode(torch.as_tensor(payload,
                                                           device=dev)), p)
    off = p.osr * int(rng.integers(0, max(p.n // 8, 1)))
    cut = min(re.shape[-1], length - off)
    sr[..., off:off + cut] += re[0, :cut]
    si[..., off:off + cut] += im[0, :cut]
    return sr.contiguous(), si.contiguous()


def _db_err(got, want, what) -> float:
    """Largest |got - want| over the finite dB values; both sides must be
    -inf at the same places (windows of zeros)."""
    fin = torch.isfinite(want)
    assert torch.equal(torch.isfinite(got), fin), (what, "non-finite dB")
    assert torch.equal(got[~fin], want[~fin]), (what, "non-finite dB")
    return float((got[fin] - want[fin]).abs().max()) if bool(fin.any()) \
        else 0.0


def _bins_and_db(got, want, what, clear_only: bool) -> float:
    """Detector outputs (index, power dB, noise dB) against the plain
    version's: bins equal on every row (``clear_only``: on every row with
    a clear peak, power - noise > 3 dB, since on noise the FFT and the
    matmul DFT may split near-ties), dB within RX_DB_ATOL everywhere.
    Returns the largest dB error."""
    gi, gp, ga = got
    wi, wp, wa = want
    rows = (wp - wa) > 3.0 if clear_only else torch.ones_like(wi, dtype=bool)
    assert bool(rows.any()), (what, "no clear row")
    flips = int((gi[rows] != wi[rows]).sum())
    assert flips == 0, (what, flips)
    err = max(_db_err(gp, wp, what), _db_err(ga, wa, what))
    assert err <= RX_DB_ATOL, (what, err)
    return err


def _scan_compare(args, what) -> float:
    """#7 against its plain version on the same inputs (bins on clear
    windows); the largest dB error."""
    return _bins_and_db(cuda_stream.stream_window_detect(*args),
                        cuda_stream.stream_window_detect_ref(*args), what,
                        clear_only=True)


def _tone_rows(n: int, rng, dev, window):
    """Phase 3's #8 inputs: tones at random bins with |cfo| up to half a
    bin and AWGN sigma 0.1, times ``window``; rates ~ N(0, 1e-3), start
    phases ~ N(0, 1)."""
    b, s = DETECT_ROWS
    k = rng.integers(0, n, (b, s, 1)) + rng.uniform(-0.5, 0.5, (b, s, 1))
    z = np.exp(2j * np.pi * k * np.arange(n) / n)
    z = (z + (rng.standard_normal(z.shape)
              + 1j * rng.standard_normal(z.shape)) * 0.1) * window
    rate = (rng.standard_normal(b) * 1e-3).astype(np.float32)
    start = rng.standard_normal((b, s)).astype(np.float32)
    return [torch.as_tensor(a, device=dev)
            for a in (z.real.astype(np.float32), z.imag.astype(np.float32),
                      rate, start)]


def _detect_compare(args, what) -> float:
    """#8 against its plain version on the same inputs (bins on every row:
    the C-reference fixtures' rows have no clear peak); the largest dB
    error."""
    return _bins_and_db(cuda_detect.fused_rotate_detect(*args),
                        cuda_detect.fused_rotate_detect_ref(*args), what,
                        clear_only=False)


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
    # #7: sf5-12 x osr 1, 2, 4 x stride step/1, step/2, step/4 (osr divides
    # each), then a (2, 3) batch of wide sf9/BW250/osr2 streams at step/8
    for sf in STREAM_SFS:
        for osr in (1, 2, 4):
            p = lora.LoraParams(sf=sf, osr=osr)
            sr, si = _packet_stream(p, STREAM_SYMBOLS, rng, dev)
            for div in (1, 2, 4):
                stride = p.step // div
                err["stream_scan"] = max(err["stream_scan"], _scan_compare(
                    (sr, si, p, stride, sr.shape[-1] // stride),
                    (sf, osr, div)))
    p = lora.LoraParams(sf=9, bw=250000, osr=2)
    sr, si = _packet_stream(p, 9, rng, dev, lead=(2, 3))
    err["stream_scan"] = max(err["stream_scan"], _scan_compare(
        (sr, si, p, p.step // 8, sr.shape[-1] // (p.step // 8)),
        ("batch (2, 3)", p.sf, p.osr)))
    # #8: sf2-9, windows ones and Hann
    for sf in SMALL_SFS:
        n = 1 << sf
        for label, win in (("ones", np.ones(n)),
                           ("hann", modem.window_table(n, lora.Window.HANN))):
            err["rotate_detect"] = max(err["rotate_detect"], _detect_compare(
                _tone_rows(n, rng, dev, win), (sf, label)))
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
          f"(tol {RX_DB_ATOL}); stream scan sf{STREAM_SFS[0]}-"
          f"{STREAM_SFS[-1]} x osr 1, 2, 4 x stride step/1, /2, /4 "
          f"({STREAM_SYMBOLS}-symbol noisy streams holding a packet) and a "
          f"(2, 3) batch of sf9/BW250/osr2 streams: bins equal on every "
          f"clear window, max |d dB| = {err['stream_scan']:.3g}; "
          f"rotate-detect sf{SMALL_SFS[0]}-{SMALL_SFS[-1]} "
          f"({DETECT_ROWS[0]} x {DETECT_ROWS[1]} rows, ones and Hann, |cfo| "
          f"<= 0.5 bin): bins equal, max |d dB| = "
          f"{err['rotate_detect']:.3g}", flush=True)
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
             modem.rx_window_detect, streaming.stream_window_detect,
             tones.fused_rotate_detect)
    cuda_tx.tx_tone_synth = cuda_tx.tx_tone_synth_ref
    tones.rx_window_detect = cuda_rx.rx_window_detect_ref
    modem.rx_window_detect = cuda_rx.rx_window_detect_ref
    streaming.stream_window_detect = cuda_stream.stream_window_detect_ref
    tones.fused_rotate_detect = cuda_detect.fused_rotate_detect_ref
    try:
        yield
    finally:
        (cuda_tx.tx_tone_synth, tones.rx_window_detect,
         modem.rx_window_detect, streaming.stream_window_detect,
         tones.fused_rotate_detect) = saved


@contextlib.contextmanager
def _capture(module, name: str, calls: list):
    """Record the arguments of every call of ``module.name`` in ``calls``
    (to time a kernel alone on the inputs the path gave it)."""
    fn = getattr(module, name)

    def recorded(*args, **kw):
        calls.append((args, kw))
        return fn(*args, **kw)
    setattr(module, name, recorded)
    try:
        yield
    finally:
        setattr(module, name, fn)


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


def _stream_slice(p, count: int, rng, dev):
    """A stream slice's stream: ``count`` CRC-carrying 32-byte packets
    (``_payloads``), packet k at k*(packet + 2 symbols) + u_k with u_k
    uniform in [0, step), over AWGN sigma 0.05 per plane; made on the card
    (the TX kernels modulate, a seeded generator draws the noise).
    Returns (re, im, payload, altered rows, planted starts)."""
    plen = lora.packet_samples(p, 2 * PAYLOAD)
    spacing = plen + 2 * p.step
    payload, bad = _payloads(p, count, dev, rng)
    u = torch.as_tensor(rng.integers(0, p.step, count), device=dev)
    starts = torch.arange(count, device=dev) * spacing + u
    re, im = lora.modulate(lora.encode(payload), p)
    src = torch.arange(spacing, device=dev) - u[:, None]
    inside = (src >= 0) & (src < plen)
    src.clamp_(0, plen - 1)
    gen = torch.Generator(device=dev).manual_seed(SEED + count)
    planes = []
    for x in (re, im):
        plane = torch.randn(count * spacing, generator=gen, device=dev)
        plane *= STREAM_SIGMA
        plane += (torch.gather(x, 1, src) * inside).reshape(-1)
        planes.append(plane)
    del src, inside, re, im
    return planes[0], planes[1], payload, bad, starts


def _packet_set(pk, end=None) -> list:
    """(start, bytes, crc_ok) of the valid packets whose body ends by
    ``end`` samples."""
    v = pk.valid.cpu().numpy()
    starts = pk.start.cpu().numpy()
    pay = pk.payload.cpu().numpy()
    ok = pk.crc_ok.cpu().numpy()
    return sorted((int(starts[k]), pay[k].tobytes(), bool(ok[k]))
                  for k in np.nonzero(v)[0]
                  if end is None or starts[k] < end)


def _chunked_check(sr, si, p, pk, gate: float) -> int:
    """The first STREAM_CHUNK_PACKETS packets fed in chunks of STREAM_CHUNK
    samples with carried state equal the one call's packets that complete
    inside those chunks.  Returns the number of packets compared."""
    plen = lora.packet_samples(p, 2 * PAYLOAD)
    spacing = plen + 2 * p.step
    chunks = -(-STREAM_CHUNK_PACKETS * spacing // STREAM_CHUNK)
    end = chunks * STREAM_CHUNK
    state = lora.stream_rx_init(p, 2 * PAYLOAD, device=sr.device)
    got = []
    for c in range(chunks):
        part = slice(c * STREAM_CHUNK, (c + 1) * STREAM_CHUNK)
        pc, state = lora.receive_stream(sr[part], si[part], p,
                                        payload_symbols=2 * PAYLOAD,
                                        max_packets=16, state=state,
                                        power_gate_db=gate)
        assert int(pc.n_dropped) == 0, c
        got += _packet_set(pc)
    want = _packet_set(pk, end=end - plen + 1)
    assert sorted(got) == want, (len(got), len(want))
    assert len(want) >= STREAM_CHUNK_PACKETS, len(want)
    return len(want)


def phase_stream(dev, rng, label, p, count: int, gate: float) -> dict:
    """A stream slice through ``receive_stream`` in one call, checked."""
    sr, si, payload, bad, starts = _stream_slice(p, count, rng, dev)
    wide = _is_wide(p)
    rx = _rx_kernel_name(p, wide)
    kw = {"payload_symbols": 2 * PAYLOAD, "max_packets": count,
          "power_gate_db": gate}
    calls = []
    _sync()
    _reset_counts()
    t0 = time.perf_counter()
    with _capture(streaming, "stream_window_detect", calls):
        pk, state = lora.receive_stream(sr, si, p, **kw)
    _sync()
    seconds = time.perf_counter() - t0
    launches = _counts()
    assert launches["stream_scan"] == 1 and launches[rx] > 0, launches
    assert int(pk.n_candidates) == count, int(pk.n_candidates)
    assert int(pk.n_dropped) == 0 and bool(pk.valid.all())
    assert torch.equal(pk.start, starts), \
        int((pk.start != starts).sum())
    exact = (pk.payload == payload).all(dim=-1)
    assert bool(exact.all()), int((~exact).sum())
    want_ok = np.ones(count, bool)
    want_ok[bad] = False
    assert np.array_equal(pk.crc_ok.cpu().numpy(), want_ok)
    assert bool((pk.sync_word == 0x12).all()), "sync word"
    assert int(state.offset) == sr.shape[-1]
    # #7 against its plain version on the call the path made
    (scan_args, scan_kw), = calls
    assert not scan_kw, scan_kw
    scan_err = _scan_compare(scan_args, (label, "full size"))

    with _plain_versions():
        plain, _ = lora.receive_stream(sr, si, p, **kw)
    for f in ("payload", "crc_ok", "valid", "start", "sync_word",
              "n_candidates", "n_dropped"):
        assert torch.equal(getattr(plain, f), getattr(pk, f)), f
    assert float((plain.cfo - pk.cfo).abs().max()) <= 1e-5
    assert float((plain.time_offset - pk.time_offset).abs().max()) \
        <= TIME_ATOL
    spacing = lora.packet_samples(p, 2 * PAYLOAD) + 2 * p.step
    cut = CPU_PACKETS * spacing
    cpu, _ = lora.receive_stream(sr[:cut].cpu(), si[:cut].cpu(), p,
                                 **{**kw, "max_packets": CPU_PACKETS})
    for f in ("payload", "crc_ok", "valid", "start", "sync_word"):
        assert torch.equal(getattr(cpu, f), getattr(pk, f)[:CPU_PACKETS]
                           .cpu()), f
    assert int(cpu.n_candidates) == CPU_PACKETS
    dt = float((cpu.time_offset
                - pk.time_offset[:CPU_PACKETS].cpu()).abs().max())
    assert dt <= TIME_ATOL, dt
    chunked = ""
    if label == "S7":
        chunked = (f"; the first {_chunked_check(sr, si, p, pk, gate)} "
                   f"packets "
                   f"in chunks of {STREAM_CHUNK} samples with carried state "
                   f"= the one call")
    stride, windows = scan_args[3], scan_args[4]
    print(f"phase 5S stream {label}: {_describe(p)}, one stream of "
          f"{sr.shape[-1]:,} samples ({sr.shape[-1] * 8 / 1e6:.0f} MB), "
          f"{count} packets at k*{spacing} + u_k, stride {stride}, gate "
          f"{gate} dB, through "
          f"receive_stream ({'demodulate_wide' if wide else 'demodulate_tones'}"
          f"): {count} candidates, 0 dropped, every start at its planted "
          f"offset, bytes exact, crc_ok False on exactly the {ALTERED} "
          f"altered, sync 0x12; launches stream_scan="
          f"{launches['stream_scan']} {rx}={launches[rx]}; stream_scan vs "
          f"plain on the path's call ({windows:,} windows): bins equal on "
          f"every clear window, max |d dB| = {scan_err:.3g} (tol "
          f"{RX_DB_ATOL}); plain path on the "
          f"card (whole stream) and CPU ({CPU_PACKETS}-packet prefix, "
          f"|d time_offset| {dt:.3g}) agree{chunked}; first run "
          f"{seconds:.3f} s", flush=True)
    return {"p": p, "sr": sr, "si": si, "kw": kw, "count": count,
            "launches": launches, "scan_call": calls[0], "err": scan_err}


def _route_compare(fn, args, what):
    """``fn(*args, backend="pallas")`` against ``fn(*args)``: the two-stage
    route launches the rotate-detect kernel and no fused RX kernel, and
    gives the auto route's symbols, sync words, CFO and timing, dB within
    RX_DB_ATOL.  Returns (launches, largest dB error, the kernel's calls,
    the two-stage result)."""
    calls = []
    _sync()
    _reset_counts()
    with _capture(tones, "fused_rotate_detect", calls):
        two = fn(*args, backend="pallas")
    _sync()
    launches = _counts()
    assert launches["rotate_detect"] == 1, (what, launches)
    assert all(launches[k] == 0 for k in ("rx_dense", "rx_hybrid",
                                           "rx_osr")), (what, launches)
    auto = fn(*args)
    flips = int((two.symbols != auto.symbols).sum())
    assert flips == 0, (what, flips)
    assert torch.equal(two.sync_word, auto.sync_word), what
    assert torch.equal(two.cfo, auto.cfo), what
    assert torch.equal(two.time_offset, auto.time_offset), what
    err = max(float((two.power - auto.power).abs().max()),
              float((two.power_avg - auto.power_avg).abs().max()))
    assert err <= RX_DB_ATOL, (what, err)
    return launches["rotate_detect"], err, calls, two


def _with_awgn(re, im, seed: int):
    gen = torch.Generator(device=re.device).manual_seed(seed)
    return (re + SIGMA * torch.randn(re.shape, generator=gen,
                                     device=re.device),
            im + SIGMA * torch.randn(im.shape, generator=gen,
                                     device=im.device))


def phase_detect_route(dev, slices, full_rx) -> dict:
    """The two-stage route (``backend="pallas"``) on phase 4's and 5C's
    packets (tones path) and phase 6's sf7 packets (full RX), each
    modulated again with AWGN sigma 0.03, and on the osr-1 C-reference
    fixtures with n <= 512 (full RX, the reference's demod symbols).  Each
    rotate-detect call the route made is held against its plain version on
    the same inputs (bins on every row, dB within RX_DB_ATOL); that error,
    and the dB gap to the auto route apart, are returned."""
    launches, gap, err, rows, parts = 0, 0.0, 0.0, 0, []
    first = None

    def route(fn, args, what):
        nonlocal launches, gap, err, rows, first
        k, g, calls, res = _route_compare(fn, args, what)
        launches, gap = launches + k, max(gap, g)
        for call_args, call_kw in calls:
            assert not call_kw, call_kw
            err = max(err, _detect_compare(call_args, (what, "full size")))
            rows += call_args[3].numel()
        first = first or calls[0]
        return res

    for label in ("sf7", "C"):
        sl = slices[label]
        p = sl["p"]
        dr, di = _with_awgn(*lora.modulate_dechirped(
            lora.encode(sl["payload"]), p), SEED + p.osr)
        route(lora.demodulate_tones, (dr, di, p), (label, "tones"))
        parts.append(f"demodulate_tones {label} ({dr.shape[0]} packets)")
    p = FULL_RX[0][0]
    re, im = _with_awgn(*lora.modulate(lora.encode(full_rx[7, 1]), p), SEED)
    route(lora.demodulate, (re, im, p), "full RX sf7")
    parts.append(f"demodulate sf7 ({re.shape[0]} packets)")
    names = []
    for path in sorted(VEC_DIR.glob("ref_sf*.npz")):
        d = np.load(path)
        p = lora.LoraParams(sf=int(d["sf"]), bw=int(d["bw"]),
                            osr=int(d["osr"]), window=str(d["window"]))
        if p.osr != 1 or p.n > cuda_detect.DETECT_MAX_N:
            continue
        rr, ri = lora.from_complex(d["iq"][None], device=dev)
        res = route(lora.demodulate, (rr, ri, p), path.stem)
        mine = res.symbols.cpu().numpy()[0]
        assert np.array_equal(mine, d["demod"][: len(mine)]), path.stem
        names.append(path.stem)
    assert len(names) == 4, names
    print(f"phase 6D two-stage route (backend='pallas', AWGN sigma {SIGMA}): "
          f"{', '.join(parts)} and fixtures {', '.join(names)} "
          f"(= reference demod): rotate_detect launched {launches} times and "
          f"no fused RX kernel; symbols, sync words, CFO and timing = the "
          f"auto route's, max |d dB| vs auto = {gap:.3g} (tol {RX_DB_ATOL}); "
          f"rotate_detect vs plain on every call of the route ({rows:,} "
          f"rows): bins equal on every row, max |d dB| = {err:.3g} "
          f"(tol {RX_DB_ATOL})", flush=True)
    return {"launches": launches, "err": err, "gap": gap, "call": first}


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


def _stream_bound(args, kw) -> tuple[float, str]:
    """#7: the stream read once (8 B a sample, whatever the window
    overlap), 12 B per window out, the down-chirp and twiddles once; per
    window sample the down-chirp product (6 flops), then 5 n log2 n for the
    FFT and 5 per bin for |X|^2, the sum and the first max."""
    ext_r, p, windows = args[0], args[2], args[4]
    n = p.n
    streams = ext_r.numel() // ext_r.shape[-1]
    nwin = streams * windows
    nbytes = ext_r.numel() * 8 + nwin * 12 + n * 12
    return _bound(nbytes, nwin * n * (6 + 5 + 5 * np.log2(n)))


def _detect_bound(args, kw) -> tuple[float, str]:
    """#8: the rows read once (8 B a sample), rate and start once, 12 B per
    row out, the twiddles once; per sample the phase (2 flops), its sine
    and cosine (2) and the rotation (6), then 5 n log2 n for the FFT and 5
    per bin."""
    zr, rate, start = args[0], args[2], args[3]
    rows, n = start.numel(), zr.shape[-1]
    nbytes = zr.numel() * 8 + (rate.numel() + start.numel()) * 4 \
        + rows * 12 + n * 4
    return _bound(nbytes, rows * n * (10 + 5 + 5 * np.log2(n)))


class _Windows(Exception):
    """Carries the windows a plain version hands to ``detect_ri``."""


def _cufft_ms(module, plain, call) -> float:
    """The yardstick of the FFT step alone: ``torch.fft.fft`` over the
    windows that the plain version of a kernel call hands to ``detect_ri``
    (the same windows the kernel transforms), already materialised as
    complex64, CUDA events.  It is not the kernel's function (no window
    read, no rotation, no reduction), so ``library_ms`` stays null; the
    port never calls it."""
    def grab(zr, zi):
        raise _Windows(torch.complex(zr, zi))
    args, kw = call
    saved = module.detect_ri
    module.detect_ri = grab
    try:
        plain(*args, **kw)
    except _Windows as caught:
        z = caught.args[0]
    finally:
        module.detect_ri = saved
    ms = _time_ms(lambda: torch.fft.fft(z))
    del z
    torch.cuda.empty_cache()
    return ms


def _kernel_alone(kernel, plain, call, bound) -> tuple:
    """(ms, plain ms, bound ms, bound by) of one kernel call recorded on
    the main path, run again alone."""
    args, kw = call
    return _abba(lambda: kernel(*args, **kw), lambda: plain(*args, **kw)) \
        + bound(args, kw)


def phase_timing(slices, full_rx, smi, streams, route):
    """Packets/s of each slice through the kernels and the plain versions,
    and each kernel alone beside its plain version at the slice's shapes:
    {(kernel, slice label): (ms, plain ms, bound ms, bound by)}, and the
    cuFFT yardstick {(kernel, slice label): ms} of rx_hybrid at sf12 and A
    and stream_scan at S7 and S12."""
    times, cufft = {}, {}
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
        if (rx, label) in CUFFT_AT:
            cufft[rx, label] = _cufft_ms(cuda_rx, cuda_rx.rx_window_detect_ref,
                                         sl["rx_call"])
            line += f"; cuFFT of the same windows {cufft[rx, label]:.4f} ms"
        lines.append(line)
    for label, st in streams.items():
        p, sr, si, kw, count = (st[k] for k in ("p", "sr", "si", "kw",
                                                "count"))

        def plain_rx():
            with _plain_versions():
                return lora.receive_stream(sr, si, p, **kw)
        ms, plain_ms = _abba(lambda: lora.receive_stream(sr, si, p, **kw),
                             plain_rx, iters=3)
        times["stream_scan", label] = _kernel_alone(
            cuda_stream.stream_window_detect,
            cuda_stream.stream_window_detect_ref, st["scan_call"],
            _stream_bound)
        k_ms, kp_ms, kb_ms, kb_by = times["stream_scan", label]
        msamples = sr.shape[-1] / 1e6
        ext_bytes = st["scan_call"][0][0].numel() * 8
        yard = ""
        if ("stream_scan", label) in CUFFT_AT:
            cufft["stream_scan", label] = _cufft_ms(
                cuda_stream, cuda_stream.stream_window_detect_ref,
                st["scan_call"])
            yard = (f"; cuFFT of the same windows "
                    f"{cufft['stream_scan', label]:.4f} ms")
        lines.append(
            f"stream {label} {_describe(p)} {count / (ms / 1e3):,.0f} "
            f"packets/s, {msamples / (ms / 1e3):,.1f} Msamples/s "
            f"({ms:.3f} ms / {count} packets) through the kernels, "
            f"{count / (plain_ms / 1e3):,.0f} packets/s, "
            f"{msamples / (plain_ms / 1e3):,.1f} Msamples/s "
            f"({plain_ms:.3f} ms) through the plain versions; stream_scan "
            f"{k_ms:.4f} ms vs plain {kp_ms:.4f} ms (bound {kb_ms:.4f} ms "
            f"by {kb_by}; reads the stream at "
            f"{ext_bytes / (k_ms * 1e-3) / 1e12:.3f} TB/s){yard}")
    times["rotate_detect", "sf7"] = _kernel_alone(
        cuda_detect.fused_rotate_detect, cuda_detect.fused_rotate_detect_ref,
        route["call"], _detect_bound)
    ms, plain_ms, bound_ms, bound_by = times["rotate_detect", "sf7"]
    rows = tuple(route["call"][0][0].shape[:2])
    lines.append(f"rotate_detect at sf7 ({rows[0]} x {rows[1]} rows, the "
                 f"two-stage route's) {ms:.4f} ms vs "
                 f"plain {plain_ms:.4f} ms (bound {bound_ms:.4f} ms by "
                 f"{bound_by})")
    print(f"phase 7 timing [{smi}]: " + " | ".join(lines), flush=True)
    return times, cufft


# Where phase 7 times torch.fft.fft beside a kernel (the cuFFT yardstick).
CUFFT_AT = {("rx_hybrid", "sf12"), ("rx_hybrid", "A"), ("stream_scan", "S7"),
            ("stream_scan", "S12")}
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
    ("stream_scan", "S7", "ops/pallas_stream.py:107"),
    ("rotate_detect", "sf7", "ops/pallas_detect.py:41"),
)
# (label, params, packets, power gate dB).  At the default stride step/4 a
# start midway between two windows leaves its second sync window (which
# also holds the first data symbol's head, or the first sync symbol's
# tail) at 4.6-4.9 dB under sigma 0.05, below receive_stream's default
# 5 dB gate: the JAX package's receiver and the port both miss some such
# packets, and both recover them at 4 dB, where noise alone flags nothing
# (tests/test_torch_stream.py::test_receive_stream_default_gate_misses_
# midway_starts_like_jax and ::test_receive_stream_noise_only_flags_nothing_
# at_4db).  S7 and S12 pass 4 dB; SW keeps the default.
STREAMS = (("S7", lora.LoraParams(sf=7, bw=125000, cr="4/5"), 8192, 4.0),
           ("S12", lora.LoraParams(sf=12, bw=125000, cr="4/5"), 256, 4.0),
           ("SW", lora.LoraParams(sf=9, bw=250000, cr="4/8", osr=2), 1024,
            5.0))


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
    streams = {label: phase_stream(dev, rng, label, p, count, gate)
               for label, p, count, gate in STREAMS}
    full_rx, launches = phase_full_rx(dev, rng)
    route = phase_detect_route(dev, slices, full_rx)
    times, cufft = phase_timing(slices, full_rx, smi, streams, route)
    launches["rotate_detect"] += route["launches"]
    err["rotate_detect"] = max(err["rotate_detect"], route["err"])
    for sl in list(slices.values()) + list(streams.values()):
        for name in KERNELS:
            launches[name] += sl["launches"][name]
    for st in streams.values():
        err["stream_scan"] = max(err["stream_scan"], st["err"])
    for sl in slices.values():
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
        if (name, label) in cufft:
            entry["cufft_ms"] = cufft[name, label]
        for other, at, key in (("rx_hybrid", "A", "at_16384"),
                               ("stream_scan", "S12", "at_4096")):
            if name == other:
                ms, plain_ms, bound_ms, bound_by = times[name, at]
                entry[key] = {"ms": ms, "plain_ms": plain_ms,
                              "bound_ms": bound_ms, "bound_by": bound_by,
                              "cufft_ms": cufft[name, at]}
        if name == "rotate_detect":   # the two-stage route against auto
            entry["route_db_gap_vs_auto"] = route["gap"]
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

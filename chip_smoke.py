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
   extraction kernel launched once and equal to its plain version on the
   path's call to the bit, the kernel path equal to the plain path
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
8F. framed SX1272 packets, ``encode_frame -> modulate_dechirped ->
   demodulate_tones -> decode_frame_padded``: sf7/BW125/CR4-5, 8192 x 32 B
   (58 symbols), and sf12/BW125/CR4-5, 256 x 32 B (38 symbols), 16 frames
   of each with a symbol moved beyond FEC reach, then 8192 sf7 frames of
   lengths 1-32 at ``max_payload_len`` 32: bytes, lengths, hdr_ok and
   crc_ok exact, the corrupted ones failing, the framed decoder kernel
   launched once a decode, and the plain versions on the card giving the
   same frames;
8S. framed streams through ``receive_stream_frames`` in one call, each of
   S7's length (71,303,168 samples), frames of lengths 1-32 at k*pitch +
   u_k (pitch the maximal frame plus 2 symbols), AWGN sigma 0.05: F7
   sf7/BW125/CR4-5, 8192 frames, stride 32, gate 4 dB; FW wide
   sf9/BW250/CR4-8/osr2, 896 frames, stride 128.  Every planted frame once
   at its start with exact bytes, length and verdicts, every other
   candidate failing its CRC, nothing dropped, #7 and the extraction
   kernel against their plain versions on the path's call, the framed
   decoder kernel launched once, the plain versions on the card giving the
   same
   frames, and F7's first 64 frames in chunks of 65,536 samples equal to
   the one call;
7. timing (printed, not asserted): packets/s of every slice through the
   kernels and through the plain versions (and the sf12 full RX), packets/s
   and Msamples/s of every stream slice, frames/s and Msamples/s of the
   framed sf7 slice and of F7, and each kernel alone beside its
   plain version at each slice's shapes, with CUDA events, beside its
   bound (bytes over 3.35 TB/s or float32 operations over 67 TFLOP/s, the
   larger); beside ``rx_hybrid`` at sf12 and A and ``stream_scan`` at S7
   and S12, ``torch.fft.fft`` alone over the same windows already
   materialised as complex64 (the FFT step only, a yardstick the port
   never calls); the extraction kernel alone beside its plain version at
   the benchmark's GF7 and SP12 stream calls (12,660 rows of 44,800
   samples, 512 of 270,336, from 142.6 M samples), both equal to the bit;
   the framed decoder kernel alone beside its plain version on the card at
   a GF7 call's rows and an sf7-gateway-frames-sp4 rank's (12,660 and
   25,320 rows of 348 symbols, 235 B bound), both equal to the bit;
8W. every row of ``tests/vectors/sensitivity.csv`` through ``per_sweep``
   on the card, with the packets and dB tolerance ``tests/test_sweep.py``
   gives it: 5 SNR points, the SNR at 1 % PER within tolerance of the
   committed one; and the sf7 SER waterfall within 1 dB of theory at 1e-2
   (1500 packets);
8L. LoRaWAN: 256 frames through ``build_frame -> modulate_dechirped ->
   demodulate_tones -> parse_frame``, every MIC verifying, and a flipped
   MIC byte raising ``MicMismatchError``; prints whether the host AES/CMAC
   is native or pure Python;
8R. the port's runners as subprocesses on the default device: ``tx | rx``
   unframed and framed, and ``stream_rx --framed`` on a capture of four
   frames, all five processes started together;
8P. the parallel layer (``parallel/mesh.py``, ``parallel/distributed.py``,
   the ``mesh`` path of ``receive_stream``) in five processes started
   together (``torch.multiprocessing.spawn``), which load the kernels
   phase 2 built: (a) a world of one NCCL rank, the default backend, runs
   ``global_mesh(dp=1, sp=1)`` through ``receive_stream(mesh=...)`` on 16
   sf7 packets against the one-device call; (b) four gloo ranks share
   cuda:0 with CUDA tensors (NCCL takes one rank per card): channel DP of
   phase 4's 8192 sf7 packets on ``global_mesh`` (two simulated hosts of
   two ranks, dp 2, sp 1) with no collective, payloads and CRC verdicts
   equal to the one-device run and the exact-decode rate from
   ``all_reduce``; then S7 and SW at full size, each rank drawing the
   stream phase 5S drew and keeping its block, over ``make_mesh(4, dp=1,
   sp=4)``, every ``RecoveredPackets`` field equal to phase 5S's call, and
   S7's first packets in sharded chunks of 65,536 with carried state equal
   to the one-device chunked run.  Prints the bytes each rank sends
   through collectives a call (halos, the gathered scan, the results) and
   states no scaling: four ranks on one card measure contention;
8V. ``runners/vector_dump.py`` as processes on the default device,
   unframed and ``--framed`` at sf7 and sf12, all started together: every
   integer stage identical to an in-process ``--device cpu`` run and
   ``iq_samples.csv`` within TX_ATOL (plus its 6-digit print resolution).

Phases run in the order 1-6D, 8F, 8S, 7, 8W, 8L, 8R, 8P, 8V (phase 7 times
8F's and 8S's cells).  Every slice, stream and full-RX run, each phase 8,
and each of 8P's main-path calls in its ranks counts the launches of each
kernel from just before it to just after it (differences of the port's
``COUNTS["launch.<kernel>"]``, ``utils/spans.py``); a kernel of that path
that did not launch fails the run, and 8P's launches join the kernels'
line.
It ends with a JSON line of the kernels, the ``nvidia-smi`` name/power
line, and ``{"ok": true, "device": {...}}`` as the last line.  Without a
CUDA device, or outside a checkout, it exits nonzero and prints no result.
"""
from __future__ import annotations

import contextlib
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

import lora_sdr_lightweight_standalone_library_clean_tpu_torch as lora
from lora_sdr_lightweight_standalone_library_clean_tpu_torch.models import (
    frame, modem, tones)
from lora_sdr_lightweight_standalone_library_clean_tpu_torch.models.modem import (
    TWO_PI, _full_rx_mult)
from lora_sdr_lightweight_standalone_library_clean_tpu_torch.models.tones import (
    _tones_mult)
from lora_sdr_lightweight_standalone_library_clean_tpu_torch.ops import (
    codes, cuda_detect, cuda_extract, cuda_frame, cuda_rx, cuda_stream,
    cuda_tx)
from lora_sdr_lightweight_standalone_library_clean_tpu_torch.ops.chirp import (
    _with_sync_prelude)
from lora_sdr_lightweight_standalone_library_clean_tpu_torch.parallel import (
    receiver, streaming)
from lora_sdr_lightweight_standalone_library_clean_tpu_torch.utils import (
    cuda_build, native)
from lora_sdr_lightweight_standalone_library_clean_tpu_torch.utils.spans import (
    COUNTS)
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
# samples, time_offset of a sharded call vs the one-device call: each rank
# estimates its own packets, so the estimator's matmul DFT runs on another
# batch and cuBLAS sums in another order; the fractional-bin interpolation
# is ill-conditioned (tests/test_torch_cuda.py's card-vs-CPU tolerance)
SHARD_TIME_ATOL = 0.05
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
FRAME_MAX = 32          # max_payload_len of the framed phases (bench.py:64)
FRAMES_MIXED = 8192     # phase 8F's sf7 batch of lengths 1-32
CORRUPTED = 16          # frames given a symbol beyond FEC reach (8F)
# phase 8S: one stream of S7's length (8192 x (66 + 2) symbols of 128)
FRAME_STREAM_SAMPLES = 71_303_168
FRAME_CHUNK_FRAMES = 64
LORAWAN_FRAMES = 256
MEM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12      # H100 SXM float32 outside the tensor cores
SEED = 7
VEC_DIR = Path(__file__).resolve().parent / "tests" / "vectors"
KERNELS = ["tx_dense", "tx_factored", "tx_osr", "rx_dense", "rx_hybrid",
           "rx_osr", "stream_scan", "rotate_detect", "extract_dechirp",
           "decode_frame"]
_COUNTED_FROM = {}      # COUNTS["launch.<kernel>"] at the last _reset_counts


def _smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _sync():
    torch.cuda.synchronize()


def _time_ms(fn, iters: int = 10, warmup: int = 2,
             hide_host: bool = False) -> float:
    """Mean device milliseconds per call of ``fn``, CUDA events.  With
    ``hide_host`` the card first spins for ~6 ms (``torch.cuda._sleep``),
    so the host queues the calls while it spins and a kernel shorter than
    its launch path is timed back to back, not at the host's pace."""
    for _ in range(warmup):
        fn()
    _sync()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    if hide_host:
        torch.cuda._sleep(10_000_000)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    _sync()
    return start.elapsed_time(stop) / iters


def _abba(kernel_fn, plain_fn, iters: int = 10,
          hide_host: bool = False) -> tuple[float, float]:
    """Kernel and plain times in turns (plain, kernel, kernel, plain)."""
    p1 = _time_ms(plain_fn, iters, hide_host=hide_host)
    k1 = _time_ms(kernel_fn, iters, hide_host=hide_host)
    k2 = _time_ms(kernel_fn, iters, hide_host=hide_host)
    p2 = _time_ms(plain_fn, iters, hide_host=hide_host)
    return (k1 + k2) / 2, (p1 + p2) / 2


def _reset_counts() -> None:
    _COUNTED_FROM.update({k: COUNTS["launch." + k] for k in KERNELS})


def _counts() -> dict:
    """Each kernel's launches since the last ``_reset_counts``."""
    return {k: COUNTS["launch." + k] - _COUNTED_FROM.get(k, 0)
            for k in KERNELS}


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


def _plain_decode_frame(symbols, params, max_payload_len, crc=True):
    """The framed decoder kernel's plain version, in its return form."""
    return tuple(frame.decode_frame_padded_ref(symbols, params,
                                               max_payload_len, crc))


@contextlib.contextmanager
def _plain_versions():
    """Route the entry points through the kernels' plain versions (which
    count no launches), so the same pipeline runs without the kernels."""
    saved = (cuda_tx.tx_tone_synth, tones.rx_window_detect,
             modem.rx_window_detect, streaming.stream_window_detect,
             tones.fused_rotate_detect, receiver.extract_dechirp,
             cuda_frame.decode_frame)
    cuda_tx.tx_tone_synth = cuda_tx.tx_tone_synth_ref
    tones.rx_window_detect = cuda_rx.rx_window_detect_ref
    modem.rx_window_detect = cuda_rx.rx_window_detect_ref
    streaming.stream_window_detect = cuda_stream.stream_window_detect_ref
    tones.fused_rotate_detect = cuda_detect.fused_rotate_detect_ref
    receiver.extract_dechirp = cuda_extract.extract_dechirp_ref
    cuda_frame.decode_frame = _plain_decode_frame
    try:
        yield
    finally:
        (cuda_tx.tx_tone_synth, tones.rx_window_detect,
         modem.rx_window_detect, streaming.stream_window_detect,
         tones.fused_rotate_detect, receiver.extract_dechirp,
         cuda_frame.decode_frame) = saved


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


def _extract_compare(calls, what) -> int:
    """The extraction kernel against its plain version on the one call a
    receiver made: both planes equal to the bit.  Returns the rows."""
    (args, kw), = calls
    got = cuda_extract.extract_dechirp(*args, **kw)
    want = cuda_extract.extract_dechirp_ref(*args, **kw)
    for a, b in zip(got, want):
        assert torch.equal(a, b), what
    return got[0].shape[0]


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


def _stream_chunks(p) -> int:
    """Chunks of STREAM_CHUNK samples that hold the first
    STREAM_CHUNK_PACKETS packets of a stream slice."""
    spacing = lora.packet_samples(p, 2 * PAYLOAD) + 2 * p.step
    return -(-STREAM_CHUNK_PACKETS * spacing // STREAM_CHUNK)


def _chunked_check(sr, si, p, pk, gate: float) -> list:
    """The first STREAM_CHUNK_PACKETS packets fed in chunks of STREAM_CHUNK
    samples with carried state equal the one call's packets that complete
    inside those chunks.  Returns the packets the chunks gave."""
    plen = lora.packet_samples(p, 2 * PAYLOAD)
    chunks = _stream_chunks(p)
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
    return sorted(got)


def phase_stream(dev, rng, label, p, count: int, gate: float) -> dict:
    """A stream slice through ``receive_stream`` in one call, checked.
    Keeps the generator's state before the stream was drawn, so phase 8P's
    ranks draw the same stream."""
    rng_state = rng.bit_generator.state
    sr, si, payload, bad, starts = _stream_slice(p, count, rng, dev)
    wide = _is_wide(p)
    rx = _rx_kernel_name(p, wide)
    kw = {"payload_symbols": 2 * PAYLOAD, "max_packets": count,
          "power_gate_db": gate}
    calls, ext_calls = [], []
    _sync()
    _reset_counts()
    t0 = time.perf_counter()
    with _capture(streaming, "stream_window_detect", calls), \
            _capture(receiver, "extract_dechirp", ext_calls):
        pk, state = lora.receive_stream(sr, si, p, **kw)
    _sync()
    seconds = time.perf_counter() - t0
    launches = _counts()
    assert launches["stream_scan"] == 1 and launches[rx] > 0, launches
    assert launches["extract_dechirp"] == 1, launches
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
    rows = _extract_compare(ext_calls, (label, "full size"))
    del ext_calls

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
    chunked, chunk_packets = "", None
    if label == "S7":
        chunk_packets = _chunked_check(sr, si, p, pk, gate)
        chunked = (f"; the first {len(chunk_packets)} packets "
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
          f"{launches['stream_scan']} extract_dechirp="
          f"{launches['extract_dechirp']} {rx}={launches[rx]}; stream_scan vs "
          f"plain on the path's call ({windows:,} windows): bins equal on "
          f"every clear window, max |d dB| = {scan_err:.3g} (tol "
          f"{RX_DB_ATOL}); extract_dechirp = plain on the path's call "
          f"({rows} rows) to the bit; plain path on the "
          f"card (whole stream) and CPU ({CPU_PACKETS}-packet prefix, "
          f"|d time_offset| {dt:.3g}) agree{chunked}; first run "
          f"{seconds:.3f} s", flush=True)
    return {"p": p, "sr": sr, "si": si, "kw": kw, "count": count,
            "launches": launches, "scan_call": calls[0], "err": scan_err,
            "pk": pk, "rng_state": rng_state, "chunk_packets": chunk_packets}


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


def _frame_batch(p, lengths, dev, rng):
    """Framed symbols of random payloads of the given lengths, each row
    padded to the ``FRAME_MAX`` frame's symbol count (the padding past a
    frame is ignored by the padded decoder), and the payloads zero past
    their length: (symbols, payload, on-air symbols of each frame)."""
    count = len(lengths)
    s_max = lora.max_frame_symbols(p, FRAME_MAX)
    payload = torch.zeros(count, FRAME_MAX, dtype=torch.uint8, device=dev)
    syms = torch.zeros(count, s_max, dtype=torch.int32, device=dev)
    nsym = np.zeros(count, np.int64)
    for n in np.unique(lengths):
        rows = np.nonzero(lengths == n)[0]
        pay = torch.as_tensor(
            rng.integers(0, 256, (rows.size, n)).astype(np.uint8), device=dev)
        at = torch.as_tensor(rows, device=dev)
        payload[at, :n] = pay
        s = lora.encode_frame(pay, p)
        syms[at, :s.shape[-1]] = s
        nsym[rows] = s.shape[-1]
    return syms, payload, nsym


def _framed_rx(syms, p):
    """``modulate_dechirped -> demodulate_tones -> decode_frame_padded``."""
    dr, di = lora.modulate_dechirped(syms, p)
    res = lora.demodulate_tones(dr, di, p)
    return res, lora.decode_frame_padded(res.symbols, p, FRAME_MAX)


def _framed_pipeline(payload, p):
    return _framed_rx(lora.encode_frame(payload, p), p)


def _same_frames(got, want, what) -> None:
    for f in got._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), (what, f)


def phase_framed(dev, rng) -> dict:
    """8F: framed packets through ``encode_frame -> modulate_dechirped ->
    demodulate_tones -> decode_frame_padded`` at sf7 (8192 x 32 B) and sf12
    (256 x 32 B), CORRUPTED frames of each with their first payload symbol
    moved by n/2 (two data bits flipped past the parity code), and an sf7
    batch of lengths 1-32 through the padded decoder; the plain versions
    on the card give the same frames."""
    launches = {name: 0 for name in KERNELS}
    parts, out = [], {}
    for label, p, count in (
            ("sf7", lora.LoraParams(sf=7, bw=125000, cr="4/5"), PACKETS),
            ("sf12", lora.LoraParams(sf=12, bw=125000, cr="4/5"),
             PACKETS_SF12)):
        kernels = (_tx_kernel_name(p), _rx_kernel_name(p))
        payload = torch.as_tensor(
            rng.integers(0, 256, (count, FRAME_MAX)).astype(np.uint8),
            device=dev)
        bad = np.sort(rng.choice(count, CORRUPTED, replace=False))
        syms = lora.encode_frame(payload, p)
        hdr = codes.N_HEADER_SYMBOLS
        syms[torch.as_tensor(bad, device=dev), hdr] ^= p.n // 2
        _sync()
        _reset_counts()
        t0 = time.perf_counter()
        res, fr = _framed_rx(syms, p)
        _sync()
        seconds = time.perf_counter() - t0
        got = _counts()
        assert all(got[k] > 0 for k in kernels), got
        assert got["decode_frame"] == 1, got
        assert tuple(res.symbols.shape) == (count, syms.shape[-1])
        assert bool((res.sync_word == 0x12).all()), "sync word"
        want_ok = np.ones(count, bool)
        want_ok[bad] = False
        assert bool(fr.hdr_ok.all()) and bool((fr.length == FRAME_MAX).all())
        assert np.array_equal(fr.crc_ok.cpu().numpy(), want_ok)
        exact = (fr.payload == payload).all(dim=-1).cpu().numpy()
        assert np.array_equal(exact, want_ok), np.nonzero(exact != want_ok)
        with _plain_versions():
            _same_frames(_framed_rx(syms, p)[1], fr, label)
        for k in KERNELS:
            launches[k] += got[k]
        out[label] = {"p": p, "payload": payload}
        parts.append(
            f"{_describe(p)} {count} x {FRAME_MAX} B ({syms.shape[-1]} "
            f"symbols, {count * (syms.shape[-1] + 2) * p.step / 1e6:.1f} M "
            f"samples): bytes, lengths and hdr_ok exact, crc_ok False on "
            f"exactly the {CORRUPTED} corrupted; launches "
            f"{kernels[0]}={got[kernels[0]]} {kernels[1]}={got[kernels[1]]}; "
            f"decode_frame={got['decode_frame']}; first run {seconds:.3f} s")
    p = out["sf7"]["p"]
    lengths = rng.integers(1, FRAME_MAX + 1, FRAMES_MIXED)
    syms, payload, _ = _frame_batch(p, lengths, dev, rng)
    _sync()
    _reset_counts()
    res, fr = _framed_rx(syms, p)
    _sync()
    got = _counts()
    assert got["tx_dense"] > 0 and got["rx_dense"] > 0, got
    assert got["decode_frame"] == 1, got
    assert torch.equal(fr.length.cpu(), torch.as_tensor(lengths,
                                                        dtype=torch.int32))
    assert bool(fr.hdr_ok.all()) and bool(fr.crc_ok.all())
    assert torch.equal(fr.payload, payload)
    assert int(fr.n_err.sum()) == 0
    with _plain_versions():
        _same_frames(_framed_rx(syms, p)[1], fr, "mixed")
    for k in KERNELS:
        launches[k] += got[k]
    parts.append(f"{_describe(p)} {FRAMES_MIXED} frames of lengths 1-"
                 f"{FRAME_MAX} (padded to {syms.shape[-1]} symbols) at "
                 f"max_payload_len {FRAME_MAX}: bytes, lengths, hdr_ok and "
                 f"crc_ok exact, no FEC error")
    print(f"phase 8F framed packets: {'; '.join(parts)}; the plain versions "
          f"on the card give the same frames", flush=True)
    return {"slices": out, "launches": launches}


def _frame_stream(p, count: int, rng, dev):
    """A framed stream of FRAME_STREAM_SAMPLES samples: ``count`` frames of
    random lengths 1-FRAME_MAX, frame k at k*pitch + u_k (pitch the maximal
    frame plus 2 symbols, u_k uniform in [0, step)), over AWGN sigma 0.05
    per plane; modulated by the TX kernels, noise from a seeded generator
    on the card.  Returns (re, im, payload, lengths, planted starts)."""
    plen = lora.packet_samples(p, lora.max_frame_symbols(p, FRAME_MAX))
    pitch = plen + 2 * p.step
    assert count * pitch <= FRAME_STREAM_SAMPLES, (count, pitch)
    lengths = rng.integers(1, FRAME_MAX + 1, count)
    syms, payload, nsym = _frame_batch(p, lengths, dev, rng)
    re, im = lora.modulate(syms, p)
    flen = torch.as_tensor((nsym + 2) * p.step, device=dev)
    u = torch.as_tensor(rng.integers(0, p.step, count), device=dev)
    starts = torch.arange(count, device=dev) * pitch + u
    src = torch.arange(pitch, device=dev) - u[:, None]
    inside = (src >= 0) & (src < flen[:, None])
    src.clamp_(0, plen - 1)
    gen = torch.Generator(device=dev).manual_seed(SEED + count)
    planes = []
    for x in (re, im):
        plane = torch.randn(FRAME_STREAM_SAMPLES, generator=gen, device=dev)
        plane *= STREAM_SIGMA
        plane[:count * pitch] += (torch.gather(x, 1, src) * inside).reshape(-1)
        planes.append(plane)
    del src, inside, re, im
    return planes[0], planes[1], payload, lengths, starts


def _frame_set(fr, end=None) -> list:
    """(start, bytes, length, hdr_ok, crc_ok) of the valid frames that
    start before ``end``."""
    h = {f: getattr(fr, f).cpu().numpy()
         for f in ("valid", "start", "payload", "length", "hdr_ok", "crc_ok")}
    return sorted((int(h["start"][k]),
                   h["payload"][k, :h["length"][k]].tobytes(),
                   int(h["length"][k]), bool(h["hdr_ok"][k]),
                   bool(h["crc_ok"][k]))
                  for k in np.nonzero(h["valid"])[0]
                  if end is None or h["start"][k] < end)


def _frames_chunked(sr, si, p, fr, kw) -> int:
    """The first FRAME_CHUNK_FRAMES frames fed in chunks of STREAM_CHUNK
    samples with carried state equal the one call's frames that complete
    inside those chunks.  Returns the number of frames compared."""
    plen = lora.packet_samples(p, lora.max_frame_symbols(p, FRAME_MAX))
    pitch = plen + 2 * p.step
    chunks = -(-FRAME_CHUNK_FRAMES * pitch // STREAM_CHUNK)
    end = chunks * STREAM_CHUNK
    state = lora.stream_frames_init(p, FRAME_MAX, device=sr.device)
    got = []
    for c in range(chunks):
        part = slice(c * STREAM_CHUNK, (c + 1) * STREAM_CHUNK)
        fc, state = lora.receive_stream_frames(
            sr[part], si[part], p, **{**kw, "max_packets": 64}, state=state)
        assert int(fc.n_dropped) == 0, c
        got += _frame_set(fc)
    want = _frame_set(fr, end=end - plen + 1)
    assert sorted(got) == want, (len(got), len(want))
    assert len(want) >= FRAME_CHUNK_FRAMES, len(want)
    return len(want)


def phase_frame_stream(dev, rng, label, p, count: int, stride: int,
                       gate: float) -> dict:
    """8S: a framed stream through ``receive_stream_frames`` in one call.
    Every planted frame comes back once at its start with its bytes,
    length and verdicts; other candidates (random symbols of a frame that
    pass the sync test) fail their CRC; nothing is dropped; the plain
    versions on the card give the same frames."""
    sr, si, payload, lengths, starts = _frame_stream(p, count, rng, dev)
    wide = _is_wide(p)
    rx = _rx_kernel_name(p, wide)
    kw = {"max_payload_len": FRAME_MAX, "max_packets": 2 * count,
          "stride": stride, "power_gate_db": gate}
    calls, ext_calls = [], []
    _sync()
    _reset_counts()
    t0 = time.perf_counter()
    with _capture(streaming, "stream_window_detect", calls), \
            _capture(receiver, "extract_dechirp", ext_calls):
        fr, state = lora.receive_stream_frames(sr, si, p, **kw)
    _sync()
    seconds = time.perf_counter() - t0
    launches = _counts()
    assert launches["stream_scan"] == 1 and launches[rx] > 0, launches
    assert launches["extract_dechirp"] == 1, launches
    assert launches["decode_frame"] == 1, launches
    assert int(fr.n_dropped) == 0, int(fr.n_dropped)
    assert int(state.offset) == sr.shape[-1]
    v = fr.valid.cpu().numpy()
    row_of = {int(fr_start): r for r, fr_start in
              zip(np.nonzero(v)[0], fr.start.cpu().numpy()[v])}
    assert len(row_of) == int(v.sum()), "two candidates at one start"
    rows = np.array([row_of.get(int(g), -1) for g in starts.cpu().numpy()])
    assert (rows >= 0).all(), f"{int((rows < 0).sum())} frames not found"
    rows_t = torch.as_tensor(rows, device=dev)
    assert torch.equal(fr.payload[rows_t], payload)
    assert np.array_equal(fr.length.cpu().numpy()[rows], lengths)
    assert bool(fr.hdr_ok[rows_t].all()) and bool(fr.crc_ok[rows_t].all())
    assert bool((fr.sync_word[rows_t] == 0x12).all()), "sync word"
    extra = np.setdiff1d(np.nonzero(v)[0], rows)
    assert not fr.crc_ok.cpu().numpy()[extra].any(), "a false frame passed"
    (scan_args, scan_kw), = calls
    scan_err = _scan_compare(scan_args, (label, "full size"))
    ext_rows = _extract_compare(ext_calls, (label, "full size"))
    del ext_calls
    with _plain_versions():
        plain, _ = lora.receive_stream_frames(sr, si, p, **kw)
    for f in ("payload", "length", "hdr_ok", "crc_ok", "valid", "start",
              "sync_word", "n_err", "n_candidates", "n_dropped"):
        assert torch.equal(getattr(plain, f), getattr(fr, f)), f
    assert float((plain.cfo - fr.cfo).abs().max()) <= 1e-5
    assert float((plain.time_offset - fr.time_offset).abs().max()) \
        <= TIME_ATOL
    chunked = ""
    if label == "F7":
        chunked = (f"; the first {_frames_chunked(sr, si, p, fr, kw)} "
                   f"frames in chunks of {STREAM_CHUNK} samples with carried "
                   f"state = the one call")
    pitch = lora.packet_samples(p, lora.max_frame_symbols(p, FRAME_MAX)) \
        + 2 * p.step
    print(f"phase 8S framed stream {label}: {_describe(p)}, one stream of "
          f"{sr.shape[-1]:,} samples, {count} frames of lengths 1-"
          f"{FRAME_MAX} at k*{pitch} + u_k, stride {stride}, gate {gate} dB, "
          f"through receive_stream_frames "
          f"({'demodulate_wide' if wide else 'demodulate_tones'}): every "
          f"frame once at its planted start, bytes, lengths, hdr_ok and "
          f"crc_ok exact, sync 0x12, {int(fr.n_candidates)} candidates of "
          f"which {extra.size} inside frames (all failing their CRC), 0 "
          f"dropped; launches stream_scan={launches['stream_scan']} "
          f"extract_dechirp={launches['extract_dechirp']} "
          f"{rx}={launches[rx]} decode_frame={launches['decode_frame']}; "
          f"stream_scan vs plain on the path's call: "
          f"bins equal on every clear window, max |d dB| = {scan_err:.3g}; "
          f"extract_dechirp = plain on the path's call ({ext_rows} rows) "
          f"to the bit; "
          f"the plain versions on the card give the same frames{chunked}; "
          f"first run {seconds:.3f} s", flush=True)
    return {"p": p, "sr": sr, "si": si, "kw": kw, "count": count,
            "launches": launches, "err": scan_err, "seconds": seconds}


# phase 8W: each row of tests/vectors/sensitivity.csv with the LoraParams,
# packets and dB tolerance tests/test_sweep.py:102-116 gives it
# (sf7_bw125_cr47 takes sf7_bw125_cr45's)
SWEEP_ROWS = {
    "sf7_bw125_cr45": (dict(sf=7), 1500, 0.6),
    "sf7_bw125_cr47": (dict(sf=7, cr="4/7"), 1500, 0.6),
    "sf8_bw125_cr45": (dict(sf=8), 800, 0.7),
    "sf9_bw250_cr48": (dict(sf=9, bw=250000, cr="4/8", osr=2), 500, 0.8),
    "sf10_bw250_cr47": (dict(sf=10, bw=250000, cr="4/7", osr=2), 300, 0.85),
    "sf11_bw500_cr45": (dict(sf=11, bw=500000, cr="4/5", osr=4), 200, 0.9),
    "sf12_bw500_cr45": (dict(sf=12, bw=500000, cr="4/5", osr=4), 200, 0.9),
}
WATERFALL_PACKETS = 1500


def phase_sweep(dev) -> dict:
    """8W: every committed sensitivity row through ``per_sweep`` on the
    card (5 SNR points, SNR at 1 % PER within the row's tolerance), and the
    sf7 SER waterfall within 1 dB of theory at 1e-2."""
    import csv
    with (VEC_DIR / "sensitivity.csv").open() as f:
        rows = {r["profile"]: r for r in csv.DictReader(f)}
    assert set(rows) == set(SWEEP_ROWS), sorted(rows)
    _sync()
    _reset_counts()
    parts = []
    for name, (kw, packets, tol) in SWEEP_ROWS.items():
        row = rows[name]
        p = lora.LoraParams(**kw)
        want = float(row["snr_db_at_1pct_per"])
        snrs = [want - 1.0, want - 0.5, want, want + 0.5, want + 1.0]
        pts = lora.sweep.per_sweep(p, snrs, packets=packets, payload_len=16,
                                   seed=11, receiver=row["receiver"],
                                   device=dev)
        got = lora.sweep.snr_at_level(pts, 1e-2, field="per")
        assert abs(got - want) < tol, (name, got, want, pts)
        parts.append(f"{name} {got:.2f} dB (committed {want:.2f}, tol "
                     f"{tol}, {packets} packets)")
    snr_th = lora.sweep.snr_at_ser_theory(1e-2, 7)
    pts = lora.sweep.per_sweep(
        lora.LoraParams(sf=7), [snr_th - 1.5, snr_th - 0.75, snr_th,
                                snr_th + 0.75, snr_th + 1.5],
        packets=WATERFALL_PACKETS, payload_len=16, seed=7, device=dev)
    snr_meas = lora.sweep.snr_at_level(pts, 1e-2, field="ser")
    assert abs(snr_meas - snr_th) < 1.0, (snr_meas, snr_th, pts)
    _sync()
    launches = _counts()
    for k in ("tx_dense", "tx_osr", "rx_dense", "rx_hybrid"):
        assert launches[k] > 0, (k, launches)
    print(f"phase 8W sweep on the card, SNR at 1 % PER: {'; '.join(parts)}; "
          f"sf7 waterfall SER 1e-2 at {snr_meas:.2f} dB, theory "
          f"{snr_th:.2f} dB ({WATERFALL_PACKETS} packets); launches "
          f"{', '.join(f'{k}={v}' for k, v in launches.items() if v)}",
          flush=True)
    return {"launches": launches}


def phase_lorawan(dev, rng) -> dict:
    """8L: LORAWAN_FRAMES frames through ``build_frame ->
    modulate_dechirped -> demodulate_tones -> parse_frame`` on the card,
    every MIC verifying, and one frame with a flipped MIC byte raising
    ``MicMismatchError``."""
    wan = lora.lorawan
    key = bytes(rng.integers(0, 256, 16).astype(np.uint8))
    p = lora.LoraParams(sf=7, bw=125000, cr="4/5")
    frames, rows = [], []
    for k in range(LORAWAN_FRAMES):
        f = wan.Frame()
        f.mhdr.mtype = wan.MType.UNCONFIRMED_DATA_UP
        f.fhdr.devaddr = int(rng.integers(0, 2 ** 32))
        f.fhdr.fcnt = k
        f.fhdr.fopts = bytes(rng.integers(0, 256, 2).astype(np.uint8))
        f.payload = bytes(rng.integers(0, 256, 16).astype(np.uint8))
        frames.append(f)
        rows.append(wan.build_frame(key, f, device=dev))
    wire = bytearray(wan.serialize_frame(key, frames[0]))
    wire[-1] ^= 0x01
    rows.append(lora.encode(torch.as_tensor(
        np.frombuffer(bytes(wire), np.uint8).copy(), device=dev)[None])[0])
    syms = torch.stack(rows)
    _sync()
    _reset_counts()
    res = lora.demodulate_tones(*lora.modulate_dechirped(syms, p), p)
    for k, f in enumerate(frames):
        out = wan.parse_frame(key, res.symbols[k])
        assert (out.payload, out.fhdr.devaddr, out.fhdr.fcnt,
                out.fhdr.fopts) == (f.payload, f.fhdr.devaddr, f.fhdr.fcnt,
                                    f.fhdr.fopts), k
    try:
        wan.parse_frame(key, res.symbols[-1])
    except lora.errors.MicMismatchError:
        pass
    else:
        raise AssertionError("a flipped MIC byte verified")
    _sync()
    launches = _counts()
    assert launches["tx_dense"] > 0 and launches["rx_dense"] > 0, launches
    crypto = "native" if native.available() else "pure Python"
    print(f"phase 8L LoRaWAN: {LORAWAN_FRAMES} frames ({syms.shape[-1]} "
          f"symbols, {_describe(p)}) through build_frame -> "
          f"modulate_dechirped -> demodulate_tones -> parse_frame on the "
          f"card, every MIC verified; a flipped MIC byte raised "
          f"MicMismatchError; host AES/CMAC {crypto}; launches "
          f"tx_dense={launches['tx_dense']} rx_dense={launches['rx_dense']}",
          flush=True)
    return {"launches": launches}


def phase_runners(dev, rng) -> None:
    """8R: the port's runners as subprocesses on the default device (the
    card): ``tx | rx`` unframed and framed, and ``stream_rx --framed`` on a
    capture of a few frames, all started together."""
    work = Path(__file__).resolve().parent / "build" / "chip_smoke_runners"
    work.mkdir(parents=True, exist_ok=True)
    p = lora.LoraParams(sf=7, cr="4/8")
    offsets, pays = (3008, 12000, 21000, 30016), []
    sr = (rng.standard_normal(40960) * STREAM_SIGMA).astype(np.float32)
    si = (rng.standard_normal(40960) * STREAM_SIGMA).astype(np.float32)
    for g, n in zip(offsets, (5, 12, 1, 16)):
        pay = rng.integers(0, 256, n).astype(np.uint8)
        pays.append(pay)
        re, im = lora.modulate(lora.encode_frame(
            torch.as_tensor(pay, device=dev)[None], p), p)
        sr[g:g + re.shape[-1]] += re[0].cpu().numpy()
        si[g:g + re.shape[-1]] += im[0].cpu().numpy()
    inter = np.empty(2 * sr.size, np.float32)
    inter[0::2], inter[1::2] = sr, si
    cap = work / "frames.f32"
    inter.tofile(cap)

    def cmd(mod, *args):
        return [sys.executable, "-m", f"{PKG}.runners.{mod}", *args]
    pipes = {"unframed": ("DEADBEEFCAFEF00D", ["--sf=7"]),
             "framed": ("DEADBEEFCAFE01", ["--sf=8", "--cr=4/6", "--framed"])}
    procs = []
    try:
        started = time.perf_counter()
        for payload, flags in pipes.values():
            tx = subprocess.Popen(cmd("tx", f"--payload={payload}",
                                      "--out=-", *flags),
                                  stdout=subprocess.PIPE, cwd=work.parent.parent)
            rx = subprocess.Popen(cmd("rx", "--in=-", *flags),
                                  stdin=tx.stdout, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE,
                                  cwd=work.parent.parent)
            tx.stdout.close()
            procs += [tx, rx]
        stream = subprocess.Popen(
            cmd("stream_rx", f"--in={cap}", "--sf=7", "--cr=4/8",
                "--payload-bytes=16", "--framed"),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            cwd=work.parent.parent)
        procs.append(stream)
        outs = [proc.communicate(timeout=300) for proc in procs[1::2]] + \
            [stream.communicate(timeout=300)]
        seconds = time.perf_counter() - started
        for proc in procs:
            assert proc.wait(timeout=60) == 0, (proc.args, outs)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for (payload, _), (out, err) in zip(pipes.values(), outs):
        assert out.decode().strip() == payload, (out, err)
    (out, err) = outs[-1]
    lines = [line.split() for line in out.decode().splitlines()]
    want = [[str(g), "1", bytes(pay).hex().upper(), f"len={pay.size}",
             "hdr_ok=1"] for g, pay in zip(offsets, pays)]
    assert lines == want, (lines, want, err)
    print(f"phase 8R runners on the card (default device): tx | rx unframed "
          f"and framed (sf8/CR4-6) give their payloads, stream_rx --framed "
          f"finds {len(lines)} frames of lengths "
          f"{', '.join(str(x.size) for x in pays)} at their offsets with "
          f"their bytes; 5 processes started together, {seconds:.1f} s",
          flush=True)


PARALLEL_RANKS = 4          # gloo ranks that share the card in phase 8P
PARALLEL_SMALL = 16         # packets of the NCCL world-of-one stream
PARALLEL_TIMEOUT = 600      # seconds for phase 8P's processes


@contextlib.contextmanager
def _counted_collectives(calls: list):
    """Record in ``calls`` every collective of ``torch.distributed`` and of
    the functional collectives (which DTensor uses) called inside."""
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol
    saved = []
    for mod, names in ((dist, ("all_gather", "all_gather_into_tensor",
                                "all_reduce", "broadcast", "scatter",
                                "reduce_scatter_tensor")),
                       (funcol, ("all_gather_tensor", "all_reduce",
                                 "broadcast", "reduce_scatter_tensor"))):
        for name in names:
            fn = getattr(mod, name)
            saved.append((mod, name, fn))

            def counted(*args, _fn=fn, _name=name, **kw):
                calls.append(_name)
                return _fn(*args, **kw)
            setattr(mod, name, counted)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def _same_packets(pk, want: dict, what) -> tuple[float, float]:
    """Every field of ``pk`` equal to ``want`` (numpy, the one-device
    call's): integers exact, CFO within 1e-5 and timing within
    SHARD_TIME_ATOL.  Returns the largest |d CFO| and |d timing|."""
    for f in ("payload", "crc_ok", "valid", "start", "sync_word",
              "n_candidates", "n_dropped"):
        assert np.array_equal(getattr(pk, f).cpu().numpy(), want[f]), \
            (what, f)
    dcfo = float(np.abs(pk.cfo.cpu().numpy() - want["cfo"]).max())
    dt = float(np.abs(pk.time_offset.cpu().numpy()
                      - want["time_offset"]).max())
    assert dcfo <= 1e-5 and dt <= SHARD_TIME_ATOL, (what, dcfo, dt)
    return dcfo, dt


def _sharded_rx(mesh, sr, si, p, kw, state=None):
    """One sp-sharded ``receive_stream`` call on the main path: the chunk
    placed as DTensors (each rank keeps its block), the launch counts set
    to 0 just before and read just after.  Returns (packets, state,
    launches, collective bytes this rank sent by kind, seconds)."""
    from lora_sdr_lightweight_standalone_library_clean_tpu_torch.parallel import (
        distributed)
    gr = distributed.make_global_array(sr, distributed.stream_sharding(mesh))
    gi = distributed.make_global_array(si, distributed.stream_sharding(mesh))
    kinds = ("halo", "scan", "results")
    before = {k: COUNTS["collective_bytes." + k] for k in kinds}
    _sync()
    _reset_counts()
    t0 = time.perf_counter()
    pk, state = lora.receive_stream(gr, gi, p, state=state, mesh=mesh, **kw)
    _sync()
    seconds = time.perf_counter() - t0
    sent = {k: COUNTS["collective_bytes." + k] - before[k] for k in kinds}
    return pk, state, _counts(), sent, seconds


def _parallel_nccl(port: int, dev, inp: dict) -> dict:
    """8P (a): a world of one NCCL rank, the default backend, runs
    ``global_mesh(dp=1, sp=1)`` through ``receive_stream(mesh=...)`` on a
    small sf7 stream, against the one-device call."""
    import torch.distributed as dist
    from lora_sdr_lightweight_standalone_library_clean_tpu_torch.parallel import (
        distributed)
    os.environ["LOCAL_WORLD_SIZE"] = "1"
    assert distributed.init_distributed(f"localhost:{port}", 1, 0)
    assert dist.get_backend() == "nccl", dist.get_backend()
    mesh = distributed.global_mesh(dp=1, sp=1)
    p = STREAMS[0][1]
    rng = np.random.default_rng(SEED)
    sr, si, _, _, starts = _stream_slice(p, PARALLEL_SMALL, rng, dev)
    kw = {"payload_symbols": 2 * PAYLOAD, "max_packets": PARALLEL_SMALL,
          "power_gate_db": STREAMS[0][3]}
    one, one_state = lora.receive_stream(sr, si, p, **kw)
    pk, state, launches, sent, seconds = _sharded_rx(mesh, sr, si, p, kw)
    _same_packets(pk, {k: v.cpu().numpy() for k, v in one._asdict().items()},
                  "NCCL world of one")
    assert torch.equal(pk.start, starts) and bool(pk.valid.all())
    assert torch.equal(state.tail_r, one_state.tail_r)
    return {"launches": launches, "sent": sent, "seconds": seconds,
            "samples": sr.shape[-1], "backend": dist.get_backend()}


def _parallel_gloo(rank: int, port: int, dev, inp: dict, states) -> dict:
    """8P (b): rank ``rank`` of four gloo ranks that share the card (CUDA
    tensors on cuda:0; NCCL takes one rank per card).  Channel DP of phase
    4's batch on ``global_mesh`` (two simulated hosts of two ranks, dp 2,
    sp 1) with zero collectives; then S7 and SW at full size and S7's first
    packets in chunks, sp-sharded over ``make_mesh(4, dp=1, sp=4)``, each
    against phase 5S's one-device call."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from lora_sdr_lightweight_standalone_library_clean_tpu_torch.parallel import (
        distributed, mesh as pmesh)
    os.environ["LOCAL_WORLD_SIZE"] = "2"
    assert distributed.init_distributed(f"localhost:{port}", PARALLEL_RANKS,
                                        rank, backend="gloo")
    out = {}
    # channel DP over ('host', 'dp')
    gmesh = distributed.global_mesh(dp=2, sp=1)
    assert tuple(gmesh.shape) == (2, 2, 1), gmesh.shape
    for h, row in enumerate(gmesh.mesh.tolist()):
        assert {r // 2 for r in np.ravel(row)} == {h}, (h, row)
    p = lora.LoraParams(sf=7, bw=125000, cr="4/5")
    shard = distributed.channel_sharding(gmesh)
    calls = []
    _sync()
    _reset_counts()
    t0 = time.perf_counter()
    with _counted_collectives(calls):
        gpay = distributed.make_global_array(inp["dp_payload"], shard)
        _, dec, crc_ok = _pipeline(gpay.to_local(), p)
        gdec = DTensor.from_local(dec, gmesh, shard, run_check=False)
    _sync()
    seconds = time.perf_counter() - t0
    assert not calls, calls
    launches = _counts()
    host, dp, _ = gmesh.get_coordinate()
    rows = slice((2 * host + dp) * dec.shape[0],
                 (2 * host + dp + 1) * dec.shape[0])
    assert gdec.shape[0] == inp["dp_payload"].shape[0]
    assert np.array_equal(dec.cpu().numpy(), inp["dp_dec"][rows])
    assert np.array_equal(crc_ok.cpu().numpy(), inp["dp_ok"][rows])
    exact = (dec == gpay.to_local()).all(dim=-1).sum().to(torch.float32)
    dist.all_reduce(exact)
    rate = float(exact) / inp["dp_payload"].shape[0]
    assert rate == 1.0, rate
    out["dp"] = {"launches": launches, "seconds": seconds, "rate": rate,
                 "packets": int(dec.shape[0])}
    # the S7 and SW streams over sp 4
    mesh = pmesh.make_mesh(PARALLEL_RANKS, dp=1, sp=PARALLEL_RANKS)
    for label, p, count, gate in STREAMS:
        if label not in states:
            continue
        rng = np.random.default_rng()
        rng.bit_generator.state = states[label]
        sr, si, _, _, _ = _stream_slice(p, count, rng, dev)
        probe = slice(None, None, 1_000_003)
        assert np.array_equal(sr[probe].cpu().numpy(), inp[f"{label}_probe"])
        kw = {"payload_symbols": 2 * PAYLOAD, "max_packets": count,
              "power_gate_db": gate}
        pk, _, launches, sent, seconds = _sharded_rx(mesh, sr, si, p, kw)
        want = {k[len(label) + 1:]: v for k, v in inp.items()
                if k.startswith(label + "_")}
        dcfo, dt = _same_packets(pk, want, label)
        out[label] = {"launches": launches, "sent": sent,
                      "seconds": seconds, "samples": sr.shape[-1],
                      "dcfo": dcfo, "dt": dt}
        if label == "S7":
            got, state, sent = [], None, dict.fromkeys(sent, 0)
            launches = dict.fromkeys(launches, 0)
            for c in range(_stream_chunks(p)):
                part = slice(c * STREAM_CHUNK, (c + 1) * STREAM_CHUNK)
                pc, state, n, b, _ = _sharded_rx(
                    mesh, sr[part], si[part], p,
                    {**kw, "max_packets": 16}, state=state)
                assert int(pc.n_dropped) == 0, c
                got += _packet_set(pc)
                launches = {k: launches[k] + n[k] for k in n}
                sent = {k: sent[k] + b[k] for k in b}
            want = [(int(s), pay.tobytes(), bool(ok)) for s, pay, ok in zip(
                inp["chunk_start"], inp["chunk_payload"], inp["chunk_ok"])]
            assert sorted(got) == want, (len(got), len(want))
            out["S7 chunked"] = {"launches": launches, "sent": sent,
                                 "packets": len(got),
                                 "chunks": _stream_chunks(p)}
        del sr, si
        torch.cuda.empty_cache()
    return out


def _parallel_rank(i: int, ports, inputs: str, out_dir: str, states) -> None:
    """One process of phase 8P: process 0 is the NCCL world of one, 1-4 the
    gloo ranks 0-3.  Writes what it measured to ``out_dir/rank<i>.json``;
    any failed check raises, which fails the phase."""
    import torch.distributed as dist
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    inp = dict(np.load(inputs))
    if i == 0:
        rep = _parallel_nccl(ports[0], dev, inp)
    else:
        rep = _parallel_gloo(i - 1, ports[1], dev, inp, states)
    dist.barrier()
    dist.destroy_process_group()
    Path(out_dir, f"rank{i}.json").write_text(json.dumps(rep))


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _fmt_bytes(sent: dict) -> str:
    return ", ".join(f"{k} {v:,} B" for k, v in sent.items())


def phase_parallel(dev, sf7_slice, streams) -> dict:
    """8P: the parallel layer on the card in five processes started
    together: a world of one NCCL rank (the default backend) and four gloo
    ranks sharing cuda:0, all loading the kernels phase 2 built.  Returns
    the launches of their main-path runs, summed."""
    import torch.multiprocessing as mp
    work = Path(__file__).resolve().parent / "build" / "chip_smoke_parallel"
    work.mkdir(parents=True, exist_ok=True)
    for old in work.glob("rank*.json"):
        old.unlink()
    p = sf7_slice["p"]
    payload = sf7_slice["payload"]
    _, dec, crc_ok = _pipeline(payload, p)
    inp = {"dp_payload": payload.cpu().numpy(), "dp_dec": dec.cpu().numpy(),
           "dp_ok": crc_ok.cpu().numpy()}
    states = {}
    for label in ("S7", "SW"):
        st = streams[label]
        states[label] = st["rng_state"]
        inp[f"{label}_probe"] = st["sr"][::1_000_003].cpu().numpy()
        for k, v in st["pk"]._asdict().items():
            inp[f"{label}_{k}"] = v.cpu().numpy()
    chunk = streams["S7"]["chunk_packets"]
    inp["chunk_start"] = np.asarray([c[0] for c in chunk])
    inp["chunk_payload"] = np.stack([np.frombuffer(c[1], np.uint8)
                                     for c in chunk])
    inp["chunk_ok"] = np.asarray([c[2] for c in chunk])
    np.savez(work / "inputs.npz", **inp)
    t0 = time.perf_counter()
    mp.spawn(_parallel_rank, nprocs=1 + PARALLEL_RANKS,
             args=((_free_port(), _free_port()), str(work / "inputs.npz"),
                   str(work), states))
    seconds = time.perf_counter() - t0
    reps = [json.loads((work / f"rank{i}.json").read_text())
            for i in range(1 + PARALLEL_RANKS)]
    launches = dict.fromkeys(KERNELS, 0)
    runs = [reps[0]] + [r[k] for r in reps[1:] for k in r]
    for run in runs:
        for name in KERNELS:
            launches[name] += run["launches"][name]
    need = {"dp": ("tx_dense", "rx_dense"), "S7": ("stream_scan", "rx_dense"),
            "SW": ("stream_scan", "rx_hybrid"),
            "S7 chunked": ("stream_scan", "rx_dense")}
    for r in reps[1:]:
        for key, names in need.items():
            assert all(r[key]["launches"][n] > 0 for n in names), (key, r)
    assert reps[0]["launches"]["stream_scan"] > 0, reps[0]
    g = reps[1]
    s7, sw = g["S7"], g["SW"]
    ck = g["S7 chunked"]
    per_rank = {label: [r[label]["sent"] for r in reps[1:]]
                for label in ("S7", "SW")}
    print(f"phase 8P parallel layer: 5 processes started together, "
          f"{seconds:.1f} s; (a) NCCL world of one ({reps[0]['backend']}): "
          f"global_mesh(dp=1, sp=1) through receive_stream(mesh=...) on "
          f"{PARALLEL_SMALL} sf7 packets ({reps[0]['samples']:,} samples) = "
          f"the one-device call, collectives sent {_fmt_bytes(reps[0]['sent'])}"
          f"; (b) {PARALLEL_RANKS} gloo ranks sharing cuda:0 (CUDA tensors; "
          f"NCCL refuses two ranks on one card): channel DP of phase 4's "
          f"{payload.shape[0]} sf7 packets on global_mesh (2 hosts x dp 2 x "
          f"sp 1, {g['dp']['packets']} a rank) with 0 collectives, payloads "
          f"and CRC verdicts = the one-device run, global exact-decode rate "
          f"{g['dp']['rate']} from all_reduce; S7 "
          f"({s7['samples']:,} samples) and SW ({sw['samples']:,}) over "
          f"make_mesh(4, dp=1, sp=4): every RecoveredPackets field = phase "
          f"5S's one-device call on every rank (integers exact; largest "
          f"|d cfo| S7 {max(r['S7']['dcfo'] for r in reps[1:]):.3g}, SW "
          f"{max(r['SW']['dcfo'] for r in reps[1:]):.3g} (tol 1e-5), "
          f"|d time_offset| S7 {max(r['S7']['dt'] for r in reps[1:]):.3g}, "
          f"SW {max(r['SW']['dt'] for r in reps[1:]):.3g} samples (tol "
          f"{SHARD_TIME_ATOL}: each rank's estimator batch differs)), "
          f"collectives sent a rank a "
          f"call (rank 0): S7 {_fmt_bytes(s7['sent'])}, SW "
          f"{_fmt_bytes(sw['sent'])}, the largest of any rank S7 "
          f"{max(sum(b.values()) for b in per_rank['S7']):,} B, SW "
          f"{max(sum(b.values()) for b in per_rank['SW']):,} B; S7's first "
          f"{ck['packets']} packets in {ck['chunks']} sharded chunks of "
          f"{STREAM_CHUNK} with carried state = the one-device chunked run "
          f"(collectives {_fmt_bytes(ck['sent'])} over the {ck['chunks']} "
          f"calls); first sharded calls S7 {s7['seconds']:.3f} s, SW "
          f"{sw['seconds']:.3f} s on rank 0 (four ranks on one card measure "
          f"contention, not scaling); launches {launches}", flush=True)
    return {"launches": launches}


# 8V's cases.  Unframed, ``demodulate`` estimates the offsets on the raw
# sync chirps, which is ill-conditioned on noise-free chirps (PARITY.md
# defect 1): on the CPU alone, IQ moved by 4e-6 (TX_ATOL) changes sf7's
# symbols in 16 of 20 draws without a channel and in 0 of 20 with sf7's
# CFO and shift below, and sf12's in 16 of 20 either way.  So the card's
# sf12 unframed demod stages cannot be held to the CPU's (its TX rounds
# differently); they are compared and reported, and every other stage is
# held exact.
VECTOR_DUMPS = {"sf7": ["--sf=7", "--bytes=16", "--seed=3", "--cfo-bins=0.3",
                        "--time-offset=3"],
                "sf12": ["--sf=12", "--bytes=4", "--seed=1"],
                "sf7 framed": ["--sf=7", "--bytes=16", "--seed=3",
                               "--framed"],
                "sf12 framed": ["--sf=12", "--bytes=8", "--seed=5",
                                "--framed"]}
ILL_CONDITIONED = {("sf12", "demod_symbols.csv"), ("sf12", "deinterleave.csv"),
                   ("sf12", "decoded.bin")}


def phase_vector_dump() -> None:
    """8V: the port's ``vector_dump`` as processes on the default device
    (the card), unframed and ``--framed`` at sf7 and sf12, all started
    together, against in-process ``--device cpu`` runs: every integer stage
    identical (but the ILL_CONDITIONED ones, reported), ``iq_samples.csv``
    within TX_ATOL plus its print resolution (``%g``, 6 significant
    digits)."""
    from lora_sdr_lightweight_standalone_library_clean_tpu_torch.runners import (
        vector_dump)
    root = Path(__file__).resolve().parent
    work = root / "build" / "chip_smoke_vectors"
    procs = []
    try:
        started = time.perf_counter()
        for name, flags in VECTOR_DUMPS.items():
            out = work / name.replace(" ", "_") / "card"
            procs.append(subprocess.Popen(
                [sys.executable, "-m", f"{PKG}.runners.vector_dump",
                 f"--out={out}", *flags], cwd=root,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE))
        for name, flags in VECTOR_DUMPS.items():
            out = work / name.replace(" ", "_") / "cpu"
            assert vector_dump.main([f"--out={out}", *flags,
                                     "--device", "cpu"]) == 0
        outs = [proc.communicate(timeout=300) for proc in procs]
        seconds = time.perf_counter() - started
        for proc, (_, err) in zip(procs, outs):
            assert proc.returncode == 0, (proc.args, err.decode()[-2000:])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    worst, differ = 0.0, []
    for name in VECTOR_DUMPS:
        card = work / name.replace(" ", "_") / "card"
        cpu = work / name.replace(" ", "_") / "cpu"
        files = sorted(f.name for f in cpu.iterdir())
        assert sorted(f.name for f in card.iterdir()) == files, name
        for f in files:
            if f == "iq_samples.csv":
                a = np.loadtxt(card / f, delimiter=",", ndmin=2)
                b = np.loadtxt(cpu / f, delimiter=",", ndmin=2)
                err = float(np.abs(a - b).max())
                assert err <= TX_ATOL + 1e-6, (name, err)
                worst = max(worst, err)
            elif (name, f) in ILL_CONDITIONED:
                if (card / f).read_bytes() != (cpu / f).read_bytes():
                    differ.append(f"{name} {f}")
            else:
                assert (card / f).read_bytes() == (cpu / f).read_bytes(), \
                    (name, f)
        if "framed" in name:
            assert (card / "decoded.bin").read_bytes() == \
                (card / "payload.bin").read_bytes(), name
    print(f"phase 8V vector_dump on the card (default device): "
          f"{', '.join(VECTOR_DUMPS)} as {len(procs)} processes started "
          f"together ({seconds:.1f} s): every integer stage identical to the "
          f"in-process --device cpu run but sf12's unframed demod stages "
          f"(ill-conditioned full RX on noise-free chirps), of which "
          f"{', '.join(differ) or 'none'} differ; iq_samples.csv max |d| "
          f"{worst:.3g} (tol {TX_ATOL} + 1e-6 print resolution), the framed "
          f"payloads decoded", flush=True)


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


def _extract_call(dev, p, chunk: int, symbols: int, packets: int,
                  valid: int, rows: int, seed: int):
    """The extraction call of a benchmark cell's stream: [tail | chunk] of
    noise, one row a packet at its pitch plus a random offset under a
    symbol, ``valid - packets`` more rows at random symbols inside the
    packets (the candidates a frame's data symbols raise), ascending, and
    ``rows - valid`` sentinel rows at 0 after them, as ``_owned_starts``
    hands them on: (args, keywords)."""
    rng = np.random.default_rng(seed)
    plen = symbols * p.step
    gen = torch.Generator(device=dev).manual_seed(seed)
    ext_r = torch.randn(plen + chunk, generator=gen, device=dev)
    ext_i = torch.randn(plen + chunk, generator=gen, device=dev)
    starts = (plen + np.arange(packets) * (chunk // packets)
              + rng.integers(0, p.step, packets))
    extra = (starts[rng.integers(0, packets, valid - packets)]
             + rng.integers(1, symbols, valid - packets) * p.step)
    pos = np.minimum(np.sort(np.concatenate([starts, extra])), chunk)
    pos = np.concatenate([pos, np.zeros(rows - valid, np.int64)])
    pos = torch.as_tensor(pos, dtype=torch.int64, device=dev)
    return (ext_r, ext_i, pos, plen, p), {}


def _extract_bound(args, kw) -> tuple[float, str]:
    """Extraction: the rows written once (8 B a sample) and the stream read
    once (8 B a sample; overlapping rows and the sentinel rows read from
    L2); 6 flops a row sample."""
    ext_r, pos, plen = args[0], args[2], args[3]
    out = pos.numel() * plen
    return _bound(out * 8 + ext_r.numel() * 8 + pos.numel() * 8, out * 6)


def _kernel_alone(kernel, plain, call, bound,
                  hide_host: bool = False) -> tuple:
    """(ms, plain ms, bound ms, bound by) of one kernel call recorded on
    the main path, run again alone."""
    args, kw = call
    return _abba(lambda: kernel(*args, **kw), lambda: plain(*args, **kw),
                 hide_host=hide_host) + bound(args, kw)


def _decode_call(dev, p, rows: int, seed: int):
    """The framed decoder's rows in a stream call of the benchmark's frame
    mix: a frame of 13-DECODE_MAX bytes every fourth row (a gateway call
    provisions 4 rows a frame), random symbols in the others (candidates
    inside frames, sentinel rows), each row the DECODE_MAX frame's
    symbols: (args, keywords)."""
    rng = np.random.default_rng(seed)
    s_need = lora.max_frame_symbols(p, DECODE_MAX)
    syms = torch.as_tensor(rng.integers(0, p.n, (rows, s_need)).astype(
        np.int32), device=dev)
    lengths = rng.integers(13, DECODE_MAX + 1, rows // 4)
    for n in np.unique(lengths):
        at = np.nonzero(lengths == n)[0]
        pay = torch.as_tensor(rng.integers(0, 256, (at.size, n)).astype(
            np.uint8), device=dev)
        s = lora.encode_frame(pay, p)
        syms[torch.as_tensor(4 * at, device=dev), :s.shape[-1]] = s
    return (syms, p, DECODE_MAX), {}


def _decode_bound(args, kw) -> tuple[float, str]:
    """The framed decoder: the symbol rows read once (4 B a symbol) and
    the outputs written once (the payload, 4 B length, 4 B n_err, 1 B
    each verdict); its integer operations are not counted."""
    syms, max_len = args[0], args[2]
    rows = syms.numel() // syms.shape[-1]
    return _bound(syms.numel() * 4 + rows * (max_len + 10), 0)


def phase_timing(slices, full_rx, smi, streams, route, framed,
                 frame_streams):
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
    sl = framed["slices"]["sf7"]
    p, payload = sl["p"], sl["payload"]
    count = payload.shape[0]
    samples = count * (lora.frame_symbols(p, FRAME_MAX) + 2) * p.step / 1e6
    ms, plain_ms = _abba(lambda: _framed_pipeline(payload, p),
                         lambda: _plain(_framed_pipeline, payload, p),
                         iters=5)
    lines.append(
        f"framed sf7 {_describe(p)} slice ({count} x {FRAME_MAX} B) "
        f"{count / (ms / 1e3):,.0f} frames/s, {samples / (ms / 1e3):,.1f} "
        f"Msamples/s ({ms:.3f} ms) through the kernels, "
        f"{count / (plain_ms / 1e3):,.0f} frames/s ({plain_ms:.3f} ms) "
        f"through the plain versions")
    for label, st in frame_streams.items():
        p, sr, si, kw, count = (st[k] for k in ("p", "sr", "si", "kw",
                                                "count"))

        def plain_frames():
            with _plain_versions():
                return lora.receive_stream_frames(sr, si, p, **kw)
        ms, plain_ms = _abba(lambda: lora.receive_stream_frames(sr, si, p,
                                                                **kw),
                             plain_frames, iters=3)
        msamples = sr.shape[-1] / 1e6
        lines.append(
            f"framed stream {label} {_describe(p)} {count / (ms / 1e3):,.0f} "
            f"frames/s, {msamples / (ms / 1e3):,.1f} Msamples/s ({ms:.3f} ms "
            f"/ {count} frames; first run {st['seconds']:.3f} s) through the "
            f"kernels, {count / (plain_ms / 1e3):,.0f} frames/s, "
            f"{msamples / (plain_ms / 1e3):,.1f} Msamples/s ({plain_ms:.3f} "
            f"ms) through the plain versions")
    times["rotate_detect", "sf7"] = _kernel_alone(
        cuda_detect.fused_rotate_detect, cuda_detect.fused_rotate_detect_ref,
        route["call"], _detect_bound)
    ms, plain_ms, bound_ms, bound_by = times["rotate_detect", "sf7"]
    rows = tuple(route["call"][0][0].shape[:2])
    lines.append(f"rotate_detect at sf7 ({rows[0]} x {rows[1]} rows, the "
                 f"two-stage route's) {ms:.4f} ms vs "
                 f"plain {plain_ms:.4f} ms (bound {bound_ms:.4f} ms by "
                 f"{bound_by})")
    for label, p, chunk, symbols, packets, valid, rows in EXTRACT_AT:
        call = _extract_call(torch.device("cuda", 0), p, chunk, symbols,
                             packets, valid, rows, SEED)
        got = cuda_extract.extract_dechirp(*call[0])
        want = cuda_extract.extract_dechirp_ref(*call[0])
        assert all(torch.equal(a, b) for a, b in zip(got, want)), label
        del got, want
        times["extract_dechirp", label] = _kernel_alone(
            cuda_extract.extract_dechirp, cuda_extract.extract_dechirp_ref,
            call, _extract_bound)
        ms, plain_ms, bound_ms, bound_by = times["extract_dechirp", label]
        lines.append(f"extract_dechirp at {label} ({rows:,} rows of "
                     f"{symbols * p.step:,} samples from {chunk:,}; = plain "
                     f"to the bit) {ms:.4f} ms vs plain {plain_ms:.4f} ms "
                     f"(bound {bound_ms:.4f} ms by {bound_by}; "
                     f"{bound_ms / ms * MEM_BYTES_PER_S / 1e12:.3f} TB/s of "
                     f"rows written and stream read once)")
        del call
        torch.cuda.empty_cache()
    for label, rows in DECODE_AT:
        call = _decode_call(torch.device("cuda", 0), DECODE_P, rows, SEED)
        got = cuda_frame.decode_frame(*call[0])
        want = _plain_decode_frame(*call[0])
        assert all(torch.equal(a, b) for a, b in zip(got, want)), label
        del got, want
        times["decode_frame", label] = _kernel_alone(
            cuda_frame.decode_frame, _plain_decode_frame, call, _decode_bound,
            hide_host=True)
        ms, plain_ms, bound_ms, bound_by = times["decode_frame", label]
        lines.append(f"decode_frame at {label} ({rows:,} rows of "
                     f"{call[0][0].shape[-1]} symbols, {DECODE_MAX} B bound; "
                     f"= plain to the bit) {ms:.4f} ms vs plain "
                     f"{plain_ms:.4f} ms (bound {bound_ms:.4f} ms by "
                     f"{bound_by}; "
                     f"{bound_ms / ms * MEM_BYTES_PER_S / 1e12:.3f} TB/s of "
                     f"rows read and outputs written once)")
        del call
    print(f"phase 7 timing [{smi}]: " + " | ".join(lines), flush=True)
    return times, cufft


# Where phase 7 times the extraction kernel: the stream calls of the
# benchmark's sf7-gateway-frames (GF7: 3,165 frames of up to 350 symbols,
# 12,660 rows, 2.77 valid a frame, the rest sentinels at 0) and
# sf12-stream-packets (SP12: 512 packets of 66 symbols, every row valid):
# (label, params, chunk samples, row symbols, packets, valid rows, rows).
EXTRACT_AT = (("GF7", lora.LoraParams(sf=7, bw=125000, cr="4/5"),
               142_606_336, 350, 3165, 8_767, 12_660),
              ("SP12", lora.LoraParams(sf=12, bw=125000, cr="4/5"),
               142_606_336, 66, 512, 512, 512))
# Where phase 7 times the framed decoder kernel: a GF7 call's rows and an
# sf7-gateway-frames-sp4 rank's, at the benchmark's profile and bound.
DECODE_P = lora.LoraParams(sf=7, bw=125000, cr="4/5")
DECODE_MAX = 235
DECODE_AT = (("GF7", 12_660), ("sp4", 25_320))
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
    ("extract_dechirp", "GF7", None),
    ("decode_frame", "GF7", None),
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


# (label, params, frames, stride, power gate dB) of phase 8S: F7 is S7's
# configuration and gate with frames of lengths 1-32; FW is SW's wide
# configuration at its default gate
FRAME_STREAMS = (
    ("F7", lora.LoraParams(sf=7, bw=125000, cr="4/5"), 8192, 32, 4.0),
    ("FW", lora.LoraParams(sf=9, bw=250000, cr="4/8", osr=2), 896, 128,
     5.0))


def run_phases(dev, rng, smi) -> list[dict]:
    """Phases 3-8V; returns the kernels' line entries."""
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
    framed = phase_framed(dev, rng)
    frame_streams = {label: phase_frame_stream(dev, rng, label, p, count,
                                               stride, gate)
                     for label, p, count, stride, gate in FRAME_STREAMS}
    times, cufft = phase_timing(slices, full_rx, smi, streams, route,
                                framed, {"F7": frame_streams["F7"]})
    for st in frame_streams.values():
        err["stream_scan"] = max(err["stream_scan"], st["err"])
        del st["sr"], st["si"]
    later = [framed, *frame_streams.values(), phase_sweep(dev),
             phase_lorawan(dev, rng)]
    phase_runners(dev, rng)
    later.append(phase_parallel(dev, slices["sf7"], streams))
    phase_vector_dump()
    for ph in later:
        for name in KERNELS:
            launches[name] += ph["launches"][name]
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
                 "replaces": replaces and f"{JAX_PKG}/{replaces}",
                 "launches": launches[name], "max_abs_err": err[name],
                 "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                 "bound_by": bound_by, "library_ms": None,
                 "timed_at": label}
        if (name, label) in cufft:
            entry["cufft_ms"] = cufft[name, label]
        for other, at, key in (("rx_hybrid", "A", "at_16384"),
                               ("stream_scan", "S12", "at_4096"),
                               ("extract_dechirp", "SP12", "at_SP12"),
                               ("decode_frame", "sp4", "at_sp4")):
            if name == other:
                ms, plain_ms, bound_ms, bound_by = times[name, at]
                entry[key] = {"ms": ms, "plain_ms": plain_ms,
                              "bound_ms": bound_ms, "bound_by": bound_by}
                if (name, at) in cufft:
                    entry[key]["cufft_ms"] = cufft[name, at]
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

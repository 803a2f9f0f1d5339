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
   multipliers ones, Hann and down-chirp x Hann);
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
6. full RX, ``modulate -> demodulate``, at sf7 (8192 packets) and sf12
   (256): the kernel path against the plain versions on the card and the
   CPU plain path on 8 packets; then every osr-1 C-reference fixture
   (``tests/vectors``) through ``demodulate`` (the reference's own demod
   symbols) and ``dechirp -> demodulate_tones`` (``(encoded * bw_scale)
   mod n``) on the card;
7. timing (printed, not asserted): packets/s of the sf7 and sf12 slices
   and of the sf12 full RX through the kernels and through the plain
   versions, and each kernel alone beside its plain version (dense ones at
   the sf7 shapes, factored TX and large-n RX at the sf12 shapes), with
   CUDA events.

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
SEED = 7
VEC_DIR = Path(__file__).resolve().parent / "tests" / "vectors"
COUNTS = ((cuda_tx, "DENSE_LAUNCHES", "tx_dense"),
          (cuda_tx, "FACTORED_LAUNCHES", "tx_factored"),
          (cuda_rx, "DENSE_LAUNCHES", "rx_dense"),
          (cuda_rx, "HYBRID_LAUNCHES", "rx_hybrid"))


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


def _noisy_packets(p, count: int, rng, dev):
    """``count`` random 32-byte packets, modulated pre-dechirped by the
    plain TX on the card, plus AWGN sigma 0.03 from numpy."""
    payload = rng.integers(0, 256, (count, PAYLOAD)).astype(np.uint8)
    syms = lora.encode(torch.as_tensor(payload, device=dev))
    dr, di = cuda_tx.tx_tone_synth_ref(_with_sync_prelude(syms, p), p,
                                       dechirp=True)
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


def _rx_compare(args, what: str, noise_db: bool = True) -> float:
    """RX kernel against its plain version on the same inputs: bins
    equal, dB within RX_DB_ATOL.  Returns the largest dB error checked."""
    gi_, gp, ga = cuda_rx.rx_window_detect(*args)
    wi_, wp, wa = cuda_rx.rx_window_detect_ref(*args)
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


def _rx_mults(p, dev):
    """The RX multipliers of phase 3: ones, Hann, down-chirp x Hann."""
    hann = lora.Window.HANN
    return {"ones": device_table(_tones_mult, p.n, lora.Window.NONE,
                                 device=dev),
            "hann": device_table(_tones_mult, p.n, hann, device=dev),
            "downchirp x hann": device_table(_full_rx_mult, p.sf,
                                             p.bw_scale, hann, device=dev)}


def phase_kernel_vs_plain(dev, rng) -> dict:
    """Returns the largest error of each kernel: {name: err}."""
    err = {name: 0.0 for _, _, name in COUNTS}
    for sf in SMALL_SFS + LARGE_SFS:
        name = "tx_dense" if sf in SMALL_SFS else "tx_factored"
        for bw in (BWS if sf in LARGE_SFS else (125000,)):
            p = lora.LoraParams(sf=sf, bw=bw)
            if sf in SMALL_SFS:
                payload = rng.integers(0, 256, (64, PAYLOAD)).astype(np.uint8)
                syms = lora.encode(torch.as_tensor(payload, device=dev))
            else:   # the full tone range: every digit-table row is used
                syms = torch.as_tensor(
                    rng.integers(0, p.n, (64, 2 * PAYLOAD)), device=dev)
            allsyms = _with_sync_prelude(syms, p)
            for dechirp in (False, True):
                err[name] = max(err[name], _tx_compare(
                    allsyms, p, (sf, bw, dechirp), 0.75, dechirp))
    for sf in SMALL_SFS + LARGE_SFS:
        name = "rx_dense" if sf in SMALL_SFS else "rx_hybrid"
        p = lora.LoraParams(sf=sf)
        b, step = 64, p.step
        dr, di = _noisy_packets(p, b, rng, dev)
        t_off = rng.integers(-step, step + 1, b).astype(np.int32)
        t_off[:3] = [0, step, -step]
        rate = (rng.standard_normal(b) * 1e-4).astype(np.float32)
        scale = rng.uniform(0.5, 1.0, b).astype(np.float32)
        args = [torch.as_tensor(a, device=dev) for a in (t_off, rate, scale)]
        if sf in SMALL_SFS:
            mults = {"ones": device_table(_tones_mult, p.n, p.window,
                                          device=dev)}
        else:
            mults = _rx_mults(p, dev)
        for label, (mr, mi) in mults.items():
            err[name] = max(err[name], _rx_compare(
                (dr, di, *args, mr, mi, p), (sf, label)))
    _sync()
    print(f"phase 3 kernel vs plain, 64 packets: TX sf{SMALL_SFS[0]}-"
          f"{SMALL_SFS[-1]} dense max |dIQ| = {err['tx_dense']:.3g}, "
          f"sf{LARGE_SFS[0]}-{LARGE_SFS[-1]} factored (BW125/250/500, full "
          f"tone range) max |dIQ| = {err['tx_factored']:.3g}, dechirp F/T "
          f"(tol {TX_ATOL}); RX bins equal, sf{SMALL_SFS[0]}-"
          f"{SMALL_SFS[-1]} dense max |d dB| = {err['rx_dense']:.3g}, "
          f"sf{LARGE_SFS[0]}-{LARGE_SFS[-1]} large-n (ones, Hann, "
          f"down-chirp x Hann) max |d dB| = {err['rx_hybrid']:.3g} "
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


def _pipeline(payload, p):
    syms = lora.encode(payload)
    dr, di = lora.modulate_dechirped(syms, p)
    res = lora.demodulate_tones(dr, di, p)
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
    """The RX kernel's inputs as ``demodulate_tones`` forms them from the
    stream and its estimate."""
    inf = float("inf")
    max_amp = torch.maximum(torch.linalg.vector_norm(dr, ord=inf, dim=-1),
                            torch.linalg.vector_norm(di, ord=inf, dim=-1))
    scale = torch.where(max_amp > 1.0, 1.0 / max_amp,
                        torch.ones_like(max_amp)).contiguous()
    t_off = torch.clamp(torch.round(res.time_offset).to(torch.int32),
                        -p.step, p.step)
    rate = -float(TWO_PI) * res.cfo / float(np.float32(p.n))
    mr, mi = device_table(_tones_mult, p.n, p.window, device=dr.device)
    return (dr, di, t_off, rate.contiguous(), scale, mr, mi, p)


def _full_size_kernel_vs_plain(payload, res, p):
    """Each kernel against its plain version at the slice's shapes: TX on
    the slice's symbol rows, RX on the stream and estimate the slice gave
    it (noise-free, where the noise dB is a rounding floor and is not
    compared) and on that stream with AWGN."""
    allsyms = _with_sync_prelude(lora.encode(payload), p)
    tx_err = _tx_compare(allsyms, p, ("full-size TX", p.sf))
    gr, gi = cuda_tx.tx_tone_synth(allsyms, p, dechirp=True)
    args = _rx_args(gr, gi, res, p)
    rx_err = _rx_compare(args, ("full-size RX", p.sf), noise_db=False)
    gen = torch.Generator(device=gr.device).manual_seed(SEED)
    nr = gr + SIGMA * torch.randn(gr.shape, generator=gen, device=gr.device)
    ni = gi + SIGMA * torch.randn(gi.shape, generator=gen, device=gi.device)
    rx_err = max(rx_err, _rx_compare((nr, ni) + args[2:],
                                     ("full-size RX with AWGN", p.sf)))
    _sync()
    return tx_err, rx_err, allsyms, args


def phase_slice(dev, rng, phase: int, sf: int, count: int, cpu_count: int,
                kernels: tuple[str, str]):
    """The slice at real size through ``kernels`` (TX, RX), checked."""
    p = lora.LoraParams(sf=sf, bw=125000, cr="4/5")
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
    assert bool(torch.equal(dec, payload)), int((dec != payload).sum())
    want_ok = np.ones(count, bool)
    want_ok[bad] = False
    got_ok = crc_ok.cpu().numpy()
    assert np.array_equal(got_ok, want_ok), np.nonzero(got_ok != want_ok)
    assert bool((res.sync_word == 0x12).all()), "sync word"

    plain, pdec, pok = _plain(_pipeline, payload, p)
    assert bool(torch.equal(plain.symbols, res.symbols)), \
        int((plain.symbols != res.symbols).sum())
    assert bool(torch.equal(pdec, dec)) and bool(torch.equal(pok, crc_ok))
    # the plain path on the CPU agrees on a small slice of the batch
    cpu_res, _, _ = _pipeline(payload[:cpu_count].cpu(), p)
    assert torch.equal(cpu_res.symbols, res.symbols[:cpu_count].cpu())
    tx_err, rx_err, allsyms, rx_args = _full_size_kernel_vs_plain(
        payload, res, p)
    rows = count * (2 * PAYLOAD + 2)
    iq_mb = 2 * 4 * rows * p.n / 1e6
    print(f"phase {phase} slice: sf{sf} {count} packets x {PAYLOAD} B "
          f"({iq_mb:.0f} MB IQ) decoded exactly, crc_ok False on exactly "
          f"the {ALTERED} altered, sync 0x12, plain path "
          f"on the card (all) and CPU ({cpu_count}) agree; launches "
          f"{kernels[0]}={launches[kernels[0]]} "
          f"{kernels[1]}={launches[kernels[1]]}; first run {seconds:.3f} s; "
          f"at {count} x {2 * PAYLOAD + 2}: TX max |dIQ| = {tx_err:.3g} "
          f"(tol {TX_ATOL}), RX bins equal, max |d dB| = {rx_err:.3g} "
          f"(tol {RX_DB_ATOL}; noise-free and with AWGN sigma {SIGMA})",
          flush=True)
    return {"p": p, "payload": payload, "launches": launches,
            "allsyms": allsyms, "rx_args": rx_args,
            "err": {kernels[0]: tx_err, kernels[1]: rx_err}}


def _fixture_checks(dev) -> list[str]:
    """Every osr-1 C-reference fixture on the card: ``demodulate`` gives
    the reference's own demod symbols, ``dechirp -> demodulate_tones``
    gives (encoded * bw_scale) mod n.  The reference's full RX cannot
    decode its own modulation (PARITY.md defect 1): symbol parity, not
    bytes."""
    names = []
    for path in sorted(VEC_DIR.glob("ref_sf*.npz")):
        d = np.load(path)
        if int(d["osr"]) != 1:
            continue
        p = lora.LoraParams(sf=int(d["sf"]), bw=int(d["bw"]), osr=1,
                            window=str(d["window"]))
        rr, ri = lora.from_complex(d["iq"][None], device=dev)
        res = lora.demodulate(rr, ri, p)
        mine = res.symbols.cpu().numpy()[0]
        assert np.array_equal(mine, d["demod"][: len(mine)]), path.stem
        tres = lora.demodulate_tones(*lora.dechirp(rr, ri, p), p)
        nsym = d["iq"].size // p.step - 2
        want = (d["encoded"][:nsym].astype(np.int64) * p.bw_scale) % p.n
        assert np.array_equal(tres.symbols.cpu().numpy()[0], want), path.stem
        names.append(path.stem)
    assert len(names) == 7, names
    return names


def phase_full_rx(dev, rng):
    """``modulate -> demodulate`` at sf7 and sf12 through the kernels,
    against the plain versions on the card and the CPU plain path; then
    the fixtures."""
    out, parts = {}, []
    for sf, count, kernels in ((7, PACKETS, ("tx_dense", "rx_dense")),
                               (12, PACKETS_SF12,
                                ("tx_factored", "rx_hybrid"))):
        p = lora.LoraParams(sf=sf, bw=125000, cr="4/5")
        payload = torch.as_tensor(
            rng.integers(0, 256, (count, PAYLOAD)).astype(np.uint8),
            device=dev)
        _sync()
        _reset_counts()
        res = _full_rx(payload, p)
        _sync()
        launches = _counts()
        assert all(launches[k] > 0 for k in kernels), launches
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
        assert dt <= TIME_ATOL, (sf, dt)
        out[sf] = payload
        parts.append(f"sf{sf} {count} packets: kernels ({kernels[0]}="
                     f"{launches[kernels[0]]}, {kernels[1]}="
                     f"{launches[kernels[1]]}) = plain on the card, = CPU "
                     f"on {CPU_PACKETS} (|d time_offset| {dt:.3g})")
    names = _fixture_checks(dev)
    print(f"phase 6 full RX: {'; '.join(parts)}; fixtures "
          f"{', '.join(names)}: demodulate = reference demod, tones path = "
          f"(encoded * bw_scale) mod n, on the card", flush=True)
    return out


def phase_timing(s7, s12, full_rx, smi):
    times = {}
    lines = []
    for sl, (tx, rx) in ((s7, ("tx_dense", "rx_dense")),
                         (s12, ("tx_factored", "rx_hybrid"))):
        p, payload, allsyms, rx_args = (sl["p"], sl["payload"],
                                        sl["allsyms"], sl["rx_args"])
        count = payload.shape[0]
        pipe_ms, pipe_plain_ms = _abba(lambda: _pipeline(payload, p),
                                       lambda: _plain(_pipeline, payload, p),
                                       iters=5)
        times[tx] = _abba(
            lambda: cuda_tx.tx_tone_synth(allsyms, p, dechirp=True),
            lambda: cuda_tx.tx_tone_synth_ref(allsyms, p, dechirp=True))
        times[rx] = _abba(lambda: cuda_rx.rx_window_detect(*rx_args),
                          lambda: cuda_rx.rx_window_detect_ref(*rx_args))
        line = (f"sf{p.sf} slice {count / (pipe_ms / 1e3):,.0f} packets/s "
                f"({pipe_ms:.3f} ms / {count} packets) through the kernels, "
                f"{count / (pipe_plain_ms / 1e3):,.0f} packets/s "
                f"({pipe_plain_ms:.3f} ms) through the plain versions")
        if p.sf == 12:
            payload = full_rx[12]
            fr_ms, fr_plain_ms = _abba(lambda: _full_rx(payload, p),
                                       lambda: _plain(_full_rx, payload, p),
                                       iters=5)
            line += (f"; sf12 full RX {count / (fr_ms / 1e3):,.0f} packets/s "
                     f"({fr_ms:.3f} ms) vs plain "
                     f"{count / (fr_plain_ms / 1e3):,.0f} "
                     f"({fr_plain_ms:.3f} ms)")
        for name in (tx, rx):
            line += (f"; {name} {times[name][0]:.4f} ms vs plain "
                     f"{times[name][1]:.4f} ms")
        lines.append(line)
    print(f"phase 7 timing [{smi}]: " + " | ".join(lines), flush=True)
    return times


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "needs one CUDA card", file=sys.stderr)
        return 1
    rng = np.random.default_rng(SEED)
    dev = torch.device("cuda", 0)
    smi = phase_environment()
    phase_build()
    err = phase_kernel_vs_plain(dev, rng)
    s7 = phase_slice(dev, rng, 4, 7, PACKETS, 64, ("tx_dense", "rx_dense"))
    s12 = phase_slice(dev, rng, 5, 12, PACKETS_SF12, CPU_PACKETS,
                      ("tx_factored", "rx_hybrid"))
    full_rx = phase_full_rx(dev, rng)
    times = phase_timing(s7, s12, full_rx, smi)
    launches = {**s7["launches"], **{k: s12["launches"][k]
                                     for k in ("tx_factored", "rx_hybrid")}}
    for sl in (s7, s12):
        for name, e in sl["err"].items():
            err[name] = max(err[name], e)
    replaces = {"tx_dense": "ops/pallas_tx.py:68",
                "tx_factored": "ops/pallas_tx.py:177",
                "rx_dense": "ops/pallas_rx.py:508",
                "rx_hybrid": "ops/pallas_rx.py:508 (hybrid DFT form, "
                             "_dft_mag_argmax :330-397)"}
    kernels = [
        {"name": name, "route": "cuda",
         "source": f"{PKG}/csrc/{name}.cu",
         "replaces": f"{JAX_PKG}/{replaces[name]}",
         "launches": launches[name], "max_abs_err": err[name],
         "ms": times[name][0], "plain_ms": times[name][1]}
        for name in ("tx_dense", "tx_factored", "rx_dense", "rx_hybrid")]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one GPU and check it.

Run from the root of a checkout, on a machine with one Hopper card:

    python3 chip_smoke.py

Phases (one line each; any failure raises and the exit code is nonzero):

1. environment: card name and power limit, torch/CUDA versions, compute
   capability 9.0, float32 matmuls in full precision (no TF32);
2. build: compile ``csrc/*.cu`` with nvcc (``utils/cuda_build.py``);
3. kernel vs plain on the card: the TX kernel against
   ``tx_tone_synth_ref`` and the RX kernel against ``rx_window_detect_ref``
   at sf2..9 on 64 packets;
4. the slice at real size: sf7/BW125/CR4-5, 8192 packets of 32 bytes
   (the batch and payload of the JAX package's ``bench.py``), through
   ``encode -> modulate_dechirped -> demodulate_tones -> decode``, with
   SX1272 CRCs in every payload and 16 payloads altered after the CRC;
   checks the bytes, the CRC verdicts, the sync word, that both kernels
   ran, and that the plain versions on the card give the same symbols;
   then each kernel against its plain version on the inputs the slice
   gave it (8192 x 66 rows/windows), and the RX kernel once more on that
   stream with AWGN;
5. timing (printed, not asserted): packets/s of phase 4's pipeline through
   the kernels and through the plain versions, and each kernel alone
   beside its plain version, with CUDA events.

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

import numpy as np
import torch

import lora_sdr_lightweight_standalone_library_clean_tpu_torch as lora
from lora_sdr_lightweight_standalone_library_clean_tpu_torch.models import (
    tones)
from lora_sdr_lightweight_standalone_library_clean_tpu_torch.models.modem import (
    TWO_PI)
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
PACKETS = 8192          # bench.py:513 batch
PAYLOAD = 32            # bench.py:64 payload bytes -> 66 symbols
ALTERED = 16            # payloads changed after their CRC was appended
TX_ATOL = 4e-6          # IQ, |kernel - plain| (tests/test_pallas.py:299)
RX_DB_ATOL = 0.05       # dB, FFT vs dense-matmul DFT summation order
SIGMA = 0.03            # AWGN of the RX comparisons (tests/test_pallas.py)
SMALL_SFS = (2, 3, 4, 5, 6, 7, 8, 9)
SEED = 7


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


def phase_kernel_vs_plain(dev, rng) -> None:
    tx_err = 0.0
    for sf in SMALL_SFS:
        p = lora.LoraParams(sf=sf)
        payload = rng.integers(0, 256, (64, PAYLOAD)).astype(np.uint8)
        allsyms = _with_sync_prelude(
            lora.encode(torch.as_tensor(payload, device=dev)), p)
        for dechirp in (False, True):
            gr, gi = cuda_tx.tx_tone_synth(allsyms, p, 0.75, dechirp=dechirp)
            wr, wi = cuda_tx.tx_tone_synth_ref(allsyms, p, 0.75,
                                               dechirp=dechirp)
            err = max(float((gr - wr).abs().max()),
                      float((gi - wi).abs().max()))
            assert err <= TX_ATOL, (sf, dechirp, err)
            tx_err = max(tx_err, err)
    rx_err = 0.0
    for sf in SMALL_SFS:
        p = lora.LoraParams(sf=sf)
        b, step = 64, p.step
        dr, di = _noisy_packets(p, b, rng, dev)
        t_off = rng.integers(-step, step + 1, b).astype(np.int32)
        t_off[:3] = [0, step, -step]
        rate = (rng.standard_normal(b) * 1e-4).astype(np.float32)
        scale = rng.uniform(0.5, 1.0, b).astype(np.float32)
        args = [torch.as_tensor(a, device=dev) for a in (t_off, rate, scale)]
        mr, mi = device_table(_tones_mult, p.n, p.window, device=dev)
        rx_err = max(rx_err, _rx_compare((dr, di, *args, mr, mi, p), sf))
    _sync()
    print(f"phase 3 kernel vs plain, 64 packets: TX sf{SMALL_SFS[0]}-"
          f"{SMALL_SFS[-1]} dechirp F/T max |dIQ| = {tx_err:.3g} "
          f"(tol {TX_ATOL}); RX sf{SMALL_SFS[0]}-{SMALL_SFS[-1]} bins "
          f"equal, max |d dB| = {rx_err:.3g} (tol {RX_DB_ATOL})", flush=True)


def _payloads(p, dev, rng):
    """8192 payloads whose last two bytes are the SX1272 CRC of bytes
    2..k-3 (the rule decode checks), then 16 of them altered."""
    payload = torch.as_tensor(
        rng.integers(0, 256, (PACKETS, PAYLOAD)).astype(np.uint8), device=dev)
    crc = lora.crc_sx1272(payload[:, 2:PAYLOAD - 2])
    payload[:, PAYLOAD - 2] = (crc & 0xFF).to(torch.uint8)
    payload[:, PAYLOAD - 1] = (crc >> 8).to(torch.uint8)
    bad = np.sort(rng.choice(PACKETS, ALTERED, replace=False))
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


@contextlib.contextmanager
def _plain_versions():
    """Route the entry points through the kernels' plain versions (which
    count no launches), so the same pipeline runs without the kernels."""
    saved = cuda_tx.tx_tone_synth, tones.rx_window_detect
    cuda_tx.tx_tone_synth = cuda_tx.tx_tone_synth_ref
    tones.rx_window_detect = cuda_rx.rx_window_detect_ref
    try:
        yield
    finally:
        cuda_tx.tx_tone_synth, tones.rx_window_detect = saved


def _pipeline_plain(payload, p):
    with _plain_versions():
        return _pipeline(payload, p)


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
    the slice's 8192 x 66 symbol rows, RX on the stream and estimate the
    slice gave it (noise-free, where the noise dB is a rounding floor and
    is not compared) and on that stream with AWGN."""
    allsyms = _with_sync_prelude(lora.encode(payload), p)
    gr, gi = cuda_tx.tx_tone_synth(allsyms, p, dechirp=True)
    wr, wi = cuda_tx.tx_tone_synth_ref(allsyms, p, dechirp=True)
    tx_err = max(float((gr - wr).abs().max()), float((gi - wi).abs().max()))
    assert tx_err <= TX_ATOL, ("full-size TX", tx_err)
    del wr, wi
    args = _rx_args(gr, gi, res, p)
    rx_err = _rx_compare(args, "full-size RX", noise_db=False)
    gen = torch.Generator(device=gr.device).manual_seed(SEED)
    nr = gr + SIGMA * torch.randn(gr.shape, generator=gen, device=gr.device)
    ni = gi + SIGMA * torch.randn(gi.shape, generator=gen, device=gi.device)
    rx_err = max(rx_err, _rx_compare((nr, ni) + args[2:],
                                     "full-size RX with AWGN"))
    _sync()
    return tx_err, rx_err, allsyms, args


def phase_slice(dev, rng):
    p = lora.LoraParams(sf=7, bw=125000, cr="4/5")
    payload, bad = _payloads(p, dev, rng)
    _sync()
    cuda_tx.KERNEL_LAUNCHES = 0
    cuda_rx.KERNEL_LAUNCHES = 0
    t0 = time.perf_counter()
    res, dec, crc_ok = _pipeline(payload, p)
    _sync()
    seconds = time.perf_counter() - t0
    launches = {"tx": cuda_tx.KERNEL_LAUNCHES, "rx": cuda_rx.KERNEL_LAUNCHES}
    assert launches["tx"] > 0 and launches["rx"] > 0, launches

    assert tuple(res.symbols.shape) == (PACKETS, 2 * PAYLOAD)
    assert bool(torch.isfinite(res.power).all()), "non-finite power"
    assert bool(torch.isfinite(res.power_avg).all()), "non-finite noise"
    assert bool(torch.equal(dec, payload)), int((dec != payload).sum())
    want_ok = np.ones(PACKETS, bool)
    want_ok[bad] = False
    got_ok = crc_ok.cpu().numpy()
    assert np.array_equal(got_ok, want_ok), np.nonzero(got_ok != want_ok)
    assert bool((res.sync_word == 0x12).all()), "sync word"

    plain, pdec, pok = _pipeline_plain(payload, p)
    assert bool(torch.equal(plain.symbols, res.symbols)), \
        int((plain.symbols != res.symbols).sum())
    assert bool(torch.equal(pdec, dec)) and bool(torch.equal(pok, crc_ok))
    # the plain path on the CPU agrees on a small slice of the batch
    small = payload[:64].cpu()
    cpu_res, cpu_dec, _ = _pipeline(small, p)
    assert torch.equal(cpu_res.symbols, res.symbols[:64].cpu())
    tx_err, rx_err, allsyms, rx_args = _full_size_kernel_vs_plain(
        payload, res, p)
    iq_mb = 2 * 4 * PACKETS * (2 * PAYLOAD + 2) * p.n / 1e6
    print(f"phase 4 slice: sf7 {PACKETS} packets x {PAYLOAD} B "
          f"({iq_mb:.0f} MB IQ) decoded exactly, crc_ok False on exactly "
          f"the {ALTERED} altered, sync 0x12, plain path on the card and "
          f"CPU agree; launches tx={launches['tx']} rx={launches['rx']}; "
          f"first run {seconds:.3f} s; at {PACKETS} x {2 * PAYLOAD + 2}: "
          f"TX max |dIQ| = {tx_err:.3g} (tol {TX_ATOL}), RX bins equal, "
          f"max |d dB| = {rx_err:.3g} (tol {RX_DB_ATOL}; noise-free and "
          f"with AWGN sigma {SIGMA})", flush=True)
    return {"p": p, "payload": payload, "launches": launches,
            "allsyms": allsyms, "rx_args": rx_args,
            "err": {"tx": tx_err, "rx": rx_err}}


def phase_timing(sl, smi):
    p, payload, allsyms, rx_args = (sl["p"], sl["payload"], sl["allsyms"],
                                    sl["rx_args"])
    pipe_ms, pipe_plain_ms = _abba(lambda: _pipeline(payload, p),
                                   lambda: _pipeline_plain(payload, p),
                                   iters=5)
    tx_ms, tx_plain_ms = _abba(
        lambda: cuda_tx.tx_tone_synth(allsyms, p, dechirp=True),
        lambda: cuda_tx.tx_tone_synth_ref(allsyms, p, dechirp=True))
    rx_ms, rx_plain_ms = _abba(lambda: cuda_rx.rx_window_detect(*rx_args),
                               lambda: cuda_rx.rx_window_detect_ref(*rx_args))
    pps = PACKETS / (pipe_ms / 1e3)
    pps_plain = PACKETS / (pipe_plain_ms / 1e3)
    print(f"phase 5 timing [{smi}]: slice {pps:,.0f} packets/s "
          f"({pipe_ms:.3f} ms / {PACKETS} packets) through the kernels, "
          f"{pps_plain:,.0f} packets/s ({pipe_plain_ms:.3f} ms) through the "
          f"plain versions; TX kernel {tx_ms:.4f} ms vs plain "
          f"{tx_plain_ms:.4f} ms; RX kernel {rx_ms:.4f} ms vs plain "
          f"{rx_plain_ms:.4f} ms", flush=True)
    return {"tx": (tx_ms, tx_plain_ms), "rx": (rx_ms, rx_plain_ms)}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "needs one CUDA card", file=sys.stderr)
        return 1
    rng = np.random.default_rng(SEED)
    dev = torch.device("cuda", 0)
    smi = phase_environment()
    phase_build()
    phase_kernel_vs_plain(dev, rng)
    sl = phase_slice(dev, rng)
    times = phase_timing(sl, smi)
    launches, err = sl["launches"], sl["err"]
    kernels = [
        {"name": "tx_dense", "route": "cuda",
         "source": f"{PKG}/csrc/tx_dense.cu",
         "replaces": f"{JAX_PKG}/ops/pallas_tx.py:68",
         "launches": launches["tx"], "max_abs_err": err["tx"],
         "ms": times["tx"][0], "plain_ms": times["tx"][1]},
        {"name": "rx_dense", "route": "cuda",
         "source": f"{PKG}/csrc/rx_dense.cu",
         "replaces": f"{JAX_PKG}/ops/pallas_rx.py:508",
         "launches": launches["rx"], "max_abs_err": err["rx"],
         "ms": times["rx"][0], "plain_ms": times["rx"][1]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

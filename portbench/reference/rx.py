"""Plain LoRa receivers: detection, CFO/timing estimate, stream search.

The semantics of the LoRa-SDR reference's legacy vector path
(``LoRaDemod.cpp:50-197``: peak normalisation, the two-symbol CFO and
timing estimate with the lowest-index tie-break, per-symbol derotation,
first-max detection, the sync-word nibbles) and of the LoRa PHY stream
receiver built on it: every stride-aligned window of [previous tail |
chunk] dechirped and detected, packet starts at arbitrary sample offsets
read off the two sync symbols' bins, each owned start extracted, dechirped
and decoded.  Written from those rules in plain PyTorch, one packet row
per batch entry; it runs in blocks so that it fits beside the program's
inputs.

``prec="f64"`` (the reference) works in float64 with complex128 FFTs.
``prec="tf32"`` (the control) works in float32 and rounds every DFT's
input to TF32, as a tensor-core product would.
"""
from __future__ import annotations

import math

import torch

from .phy import (Phy, decode_frame_padded, decode_raw, encode_raw,
                  frame_symbols, modulate, tf32_round)

__all__ = ["detect", "demod_tones", "scan", "find_starts", "receive",
           "packet_batch"]

NOISE_FLOOR_DB = -200.0
# a window whose two largest |X|^2 differ by less than this share of the
# larger, or whose power ratio lies this close to the sync gate, is a
# rounding tie: float32 and float64 may decide it either way
TIE_SHARE = 1e-4
TIE_DB = 1e-3


def _dtypes(prec: str):
    if prec not in ("f64", "tf32"):
        raise ValueError(f"prec {prec!r}")
    return (torch.float64, torch.complex128) if prec == "f64" else \
        (torch.float32, torch.complex64)


def _fft(z, prec: str):
    if prec == "tf32":
        z = torch.complex(tf32_round(z.real), tf32_round(z.imag))
    return torch.fft.fft(z, dim=-1)


def detect(z, prec: str):
    """First-max detection of the DFT of windows z (..., n), complex:
    (index, power dB, floor dB, fractional index, winning bin,
    fragile)."""
    n = z.shape[-1]
    x = _fft(z, prec)
    mag2 = x.real * x.real + x.imag * x.imag
    idx = torch.argmax(mag2, dim=-1)
    top = torch.topk(mag2, 2, dim=-1).values
    mx = top[..., 0]
    fund = torch.sqrt(mx)
    noise = torch.sqrt(torch.clamp(mag2.sum(dim=-1) - mx, min=0.0))
    scale = 20.0 * math.log10(n)
    power = 20.0 * torch.log10(fund) - scale
    floor = 20.0 * torch.log10(noise) - scale
    sel = idx[..., None]
    left = torch.sqrt(mag2.gather(-1, torch.remainder(sel - 1, n)))[..., 0]
    right = torch.sqrt(mag2.gather(-1, torch.remainder(sel + 1, n)))[..., 0]
    demon = 2.0 * fund - right - left
    findex = torch.where(demon == 0.0, torch.zeros_like(demon),
                         0.5 * (right - left) / demon)
    fragile = ((mx - top[..., 1]) <= TIE_SHARE * mx) & (mx > 0)
    return idx, power, floor, findex, x.gather(-1, sel)[..., 0], fragile


def _downchirp(phy: Phy, prec: str):
    """The base down-chirp (n samples, osr 1): conj of the symbol-0
    up-chirp."""
    if phy.osr != 1:
        raise ValueError("the plain receivers take osr 1")
    m = torch.arange(1, phy.n + 1, dtype=torch.int64)
    # up-chirp phase numerator of symbol 0 (mod 2n): bs*(m(m+1) - m n)
    num = torch.remainder(phy.bw_scale * (m * (m + 1) - m * phy.n),
                          2 * phy.n)
    phi = -num.to(torch.float64) * (math.pi / phy.n)
    return torch.polar(torch.ones_like(phi), phi).to(_dtypes(prec)[1])


def _estimate(idx, findex, peak_bin, n: int):
    """CFO (cycles per sample) and timing offset (samples) from the two
    sync symbols' winning bins, fractional bins and phases, in float32 in
    the order of LoRaDemod.cpp:100-136 (the mean bin over n, plus the
    wrapped phase step over 2 pi n; minus the mean bin's distance from the
    nearest integer, times n)."""
    f32 = torch.float32
    pi = torch.tensor(math.pi, dtype=f32)
    two_pi = torch.tensor(2.0 * math.pi, dtype=f32)
    total = (idx[:, 0].to(f32) + findex[:, 0].to(f32)) + \
        (idx[:, 1].to(f32) + findex[:, 1].to(f32))
    phase = torch.atan2(peak_bin.imag.to(f32), peak_bin.real.to(f32))
    d = phase[:, 1] - phase[:, 0]
    d = torch.where(d > pi, d - two_pi, d)
    d = torch.where(d < -pi, d + two_pi, d)
    avg = total / 2.0
    cfo = avg / float(n) + d / (two_pi * n).item()
    frac = avg - torch.floor(avg + 0.5)
    return cfo, 0.0 - frac * float(n)


def demod_tones(z, phy: Phy, prec: str) -> dict:
    """Pre-dechirped packets z (R, S * n), complex -> {symbols (R, S - 2),
    sync_word, cfo, time_offset, power (R, S), power_avg (R, S)}."""
    fdt, cdt = _dtypes(prec)
    z = z.to(cdt)
    n = phy.n
    rows, total = z.shape[0], z.shape[1] // n
    peak = torch.maximum(z.real.abs().amax(dim=1), z.imag.abs().amax(dim=1))
    scale = torch.where(peak > 1.0, 1.0 / peak, torch.ones_like(peak))
    # estimate over the two sync symbols (LoRaDemod.cpp:80-136); its
    # closing arithmetic in float32, as the reference computes it in float
    est = z[:, :2 * n].reshape(rows, 2, n) * scale[:, None, None]
    idx, _, _, findex, peak_bin, _ = detect(est, prec)
    cfo, time_offset = _estimate(idx, findex, peak_bin, n)
    # timing-shifted, derotated windows; the first (last) window reads its
    # unshifted samples when the shift is negative (positive)
    t = torch.clamp(torch.round(time_offset).to(torch.int64), -n, n)
    rate = -2.0 * math.pi * cfo.to(fdt) / n
    s = torch.arange(total, device=z.device)
    first = (s == 0)[None, :] & (t < 0)[:, None]
    last = (s == total - 1)[None, :] & (t > 0)[:, None]
    shift = torch.where(first | last, 0, t[:, None])           # (R, S)
    i = torch.arange(n, device=z.device)
    src = (s[None, :, None] * n + shift[:, :, None] + i).reshape(rows, -1)
    win = z.gather(1, src).reshape(rows, total, n) * scale[:, None, None]
    ph = rate[:, None, None] * ((s * n)[None, :, None] + t[:, None, None]
                                + i.to(fdt))
    win = win * torch.polar(torch.ones_like(ph), ph)
    sym, power, floor, _, _, _ = detect(win, prec)
    sh = phy.sf - 4 if phy.sf > 4 else 0
    sync = (((sym[:, 0] >> sh) & 0xF) << 4) | ((sym[:, 1] >> sh) & 0xF)
    return {"symbols": sym[:, 2:], "sync_word": sync, "cfo": cfo,
            "time_offset": time_offset, "power": power, "power_avg": floor}


def _rows_per_block(samples: int) -> int:
    return max(1, (1 << 23) // samples)


def scan(ext, phy: Phy, stride: int, prec: str):
    """Detection of every window ext[w*stride : w*stride + n] (zeros past
    the end), dechirped by the base down-chirp: (index, power, floor,
    fragile), one entry per window."""
    _, cdt = _dtypes(prec)
    n = phy.n
    windows = ext.shape[0] // stride
    dc = _downchirp(phy, prec).to(ext.device)
    padded = torch.nn.functional.pad(ext.to(cdt), (0, n))
    view = padded.unfold(0, n, stride)[:windows]
    outs = []
    block = _rows_per_block(n) * 8
    for lo in range(0, windows, block):
        idx, p, pav, _, _, fragile = detect(view[lo:lo + block] * dc, prec)
        outs.append((idx, p, pav, fragile))
    return tuple(torch.cat(parts) for parts in zip(*outs))


def _shift_back(x, k: int):
    out = torch.zeros_like(x)
    if k < x.shape[-1]:
        out[:x.shape[-1] - k] = x[k:]
    return out


def find_starts(idx, power, floor, phy: Phy, stride: int, gate_db: float):
    """Windows flagged as a packet start, their corrected starts, and the
    windows whose gate decision is a rounding tie: a window and the one a
    symbol later both pass the power gate, and the difference of their
    bins is the sync word's; the misalignment read off the first bin moves
    the start; a flag next to one with a start within 2 samples is a
    duplicate."""
    n, bs = phy.n, phy.bw_scale
    hop = phy.step // stride
    sw0, sw1 = phy.sync_symbols()
    margin = (torch.clamp(power, min=NOISE_FLOOR_DB)
              - torch.clamp(floor, min=NOISE_FLOOR_DB))
    strong = margin > gate_db
    gate_tie = (margin - gate_db).abs() <= TIE_DB
    diff = torch.remainder(_shift_back(idx, hop) - idx, n)
    flagged = strong & _shift_back(strong, hop) & (diff == ((sw1 - sw0) * bs) % n)
    d = torch.remainder(idx - sw0 * bs, n)
    d = torch.where(d > n // 2, d - n, d)
    d = torch.div(d * phy.osr, bs, rounding_mode="floor")
    start = torch.arange(idx.shape[0], device=idx.device) * stride - d
    prev_flag = torch.zeros_like(flagged)
    prev_flag[1:] = flagged[:-1]
    prev_start = torch.zeros_like(start)
    prev_start[1:] = start[:-1]
    keep = flagged & ~(prev_flag & ((start - prev_start).abs() <= 2))
    return keep, start, gate_tie


def receive(sr, si, phy: Phy, *, frames: bool, payload_len: int,
            max_packets: int, stride: int, gate_db: float,
            prec: str) -> dict:
    """One whole stream, from a fresh state, through the stream receiver:
    {start (K,) of the valid slots ascending, the decoded fields of each,
    n_candidates, n_dropped, fragile (windows)}.  ``frames``: SX1272 frames
    of up to ``payload_len`` bytes (header-driven); else raw packets of
    ``payload_len`` bytes."""
    fdt, cdt = _dtypes(prec)
    n = phy.n
    symbols = (frame_symbols(phy, payload_len) if frames
               else 2 * payload_len)
    plen = (symbols + 2) * phy.step
    chunk = sr.shape[0]
    ext = torch.cat([torch.zeros(plen, dtype=fdt, device=sr.device),
                     sr.to(fdt)]) + 1j * torch.cat(
        [torch.zeros(plen, dtype=fdt, device=sr.device), si.to(fdt)])
    idx, power, floor, fragile = scan(ext, phy, stride, prec)
    keep, start, gate_tie = find_starts(idx, power, floor, phy, stride,
                                        gate_db)
    owned = keep & (start > 0) & (start <= chunk)
    starts = torch.sort(start[owned]).values
    count = int(starts.numel())
    starts = starts[:max_packets]
    dc = _downchirp(phy, prec).to(sr.device).repeat(symbols + 2)
    fields = []
    block = _rows_per_block(plen)
    for lo in range(0, starts.numel(), block):
        at = starts[lo:lo + block]
        rows = ext[at[:, None] + torch.arange(plen, device=sr.device)]
        res = demod_tones(rows * dc, phy, prec)
        if frames:
            dec = decode_frame_padded(res["symbols"], phy, payload_len)
        else:
            by, ok = decode_raw(res["symbols"])
            dec = {"payload": by, "crc_ok": ok}
        dec.update(sync_word=res["sync_word"], cfo=res["cfo"],
                   time_offset=res["time_offset"])
        fields.append(dec)
    out = {k: torch.cat([f[k] for f in fields]) for k in fields[0]} \
        if fields else {}
    out.update(start=starts - plen, n_candidates=count,
               n_dropped=max(0, count - max_packets),
               fragile=fragile | gate_tie, plen=plen)
    return out


def packet_batch(payload, phy: Phy, prec: str) -> dict:
    """Raw packets through modulate (pre-dechirped) -> demodulate ->
    decode: {dr, di (the pre-dechirped IQ), symbols, sync_word, cfo,
    time_offset, power, power_avg, payload, crc_ok}."""
    fdt, _ = _dtypes(prec)
    sym = encode_raw(payload)
    samples = (sym.shape[1] + 2) * phy.step
    parts = []
    block = _rows_per_block(samples)
    for lo in range(0, sym.shape[0], block):
        dr, di = modulate(sym[lo:lo + block], phy, dechirped=True, prec=prec)
        res = demod_tones(torch.complex(dr.to(fdt), di.to(fdt)), phy, prec)
        by, ok = decode_raw(res["symbols"])
        res.update(dr=dr, di=di, payload=by, crc_ok=ok)
        parts.append(res)
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}

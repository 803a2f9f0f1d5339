"""The general traffic generator: one input of a traffic mix, from a seed.

A mix is a data file, ``portbench/traffic/<mix>.json``: its ``kind``
names the module ``portbench/kinds/<kind>.py`` that shapes its inputs,
and its other keys set their sizes; ``pool`` is the number of inputs a
run cycles through, and ``in_flight`` (1 if absent) the calls the
window's caller keeps sent and unfinished (``run.py``).  Every input is
made on the run's device from a ``torch.Generator`` seeded by (seed,
index), and modulated by the benchmark's own plain modulator
(``reference/phy.py``), never by the program under test.  The pieces the
kinds share are here: the random payloads with SX1272 CRCs and altered
bytes, and the continuous stream that holds packets at a pitch with
jitter under AWGN.
"""
from __future__ import annotations

import hashlib
from typing import NamedTuple

import torch

from .reference.phy import Phy, crc_sx1272

__all__ = ["Input", "build", "generator", "crc_payloads", "alter",
           "stride", "pitch", "slots", "stream", "stream_shapes"]


class Input(NamedTuple):
    """One input of the pool: the program's arguments (device tensors),
    what was planted in them, and what they offer."""

    args: tuple
    truth: dict
    packets: int
    samples: int


def generator(seed: int, index: int, device) -> torch.Generator:
    digest = hashlib.sha256(f"{seed}:{index}".encode()).digest()
    g = torch.Generator(device=device)
    g.manual_seed(int.from_bytes(digest[:8], "little") >> 1)
    return g


def build(kind, mix: dict, phy: Phy, seed: int, index: int,
          device) -> Input:
    """Input ``index`` of the pool of ``seed``, made by ``kind.build``."""
    return kind.build(mix, phy, generator(seed, index, device),
                      torch.device(device))


def crc_payloads(count: int, length: int, altered: int, g, dev):
    """Random payloads whose last two bytes are the SX1272 CRC of bytes
    2 .. L-3, then ``altered`` of them with one byte of 2 .. L-3 changed:
    (payload, altered mask)."""
    p = torch.randint(0, 256, (count, length), generator=g, device=dev)
    crc = crc_sx1272(p[:, 2:length - 2])
    p[:, length - 2] = crc & 0xFF
    p[:, length - 1] = crc >> 8
    bad = alter(p, torch.full((count,), length - 2, device=dev), altered,
                g, lo=2)
    return p, bad


def alter(p, length, altered: int, g, lo: int = 0):
    """XOR a random byte in [lo, length) of ``altered`` random rows of
    ``p`` (in place) with 1 .. 255: the altered mask."""
    count = p.shape[0]
    dev = p.device
    rows = torch.randperm(count, generator=g, device=dev)[:altered]
    altered = rows.numel()
    span = (length[rows] - lo).to(torch.float64)
    pos = lo + (torch.rand(altered, generator=g, device=dev, dtype=torch.float64)
                * span).to(torch.int64)
    p[rows, pos] ^= torch.randint(1, 256, (altered,), generator=g, device=dev)
    bad = torch.zeros(count, dtype=torch.bool, device=dev)
    bad[rows] = True
    return bad


# A stream mix's keys: stream_samples, gap_symbols, jitter_symbols, sigma,
# windows_per_symbol, power_gate_db, slots_per_packet.  ``row_symbols`` is
# what a packet (frame) row holds past its sync prelude: the maximal
# frame, or the raw packet's codewords.

def stride(mix: dict, phy: Phy) -> int:
    return phy.step // mix["windows_per_symbol"]


def pitch(mix: dict, phy: Phy, row_symbols: int) -> int:
    return (row_symbols + 2 + mix["gap_symbols"]) * phy.step


def slots(mix: dict, phy: Phy, row_symbols: int) -> int:
    """The receiver's ``max_packets``: slots per planted packet times the
    packets a stream holds."""
    count = mix["stream_samples"] // pitch(mix, phy, row_symbols)
    return mix["slots_per_packet"] * count


def stream(rows_re, rows_im, flen, mix: dict, phy: Phy, row_symbols: int,
           g, dev):
    """Rows of modulated packets placed in a stream of noise: row k at
    k * pitch + u_k, u_k uniform in [0, jitter_symbols * step), its first
    ``flen[k]`` samples, under AWGN of ``sigma`` per plane.  (re, im,
    starts)."""
    count, width = rows_re.shape
    spacing = pitch(mix, phy, row_symbols)
    total = mix["stream_samples"]
    u = torch.randint(0, mix["jitter_symbols"] * phy.step, (count,),
                      generator=g, device=dev)
    starts = torch.arange(count, device=dev) * spacing + u
    src = torch.arange(spacing, device=dev) - u[:, None]
    inside = (src >= 0) & (src < flen[:, None])
    src.clamp_(0, width - 1)
    planes = []
    for x in (rows_re, rows_im):
        plane = torch.randn(total, generator=g, device=dev) * mix["sigma"]
        body = (torch.gather(x, 1, src) * inside).to(torch.float32)
        plane[:count * spacing] += body.reshape(-1)
        planes.append(plane)
    return planes[0], planes[1], starts


def stream_shapes(mix: dict, phy: Phy, row_symbols: int) -> dict:
    """The sizes of one stream call that the roofline counts read."""
    plen = (row_symbols + 2) * phy.step
    ext = plen + mix["stream_samples"]
    return {"n": phy.n, "stride": stride(mix, phy), "row_samples": plen,
            "slots": slots(mix, phy, row_symbols), "ext_samples": ext,
            "windows": ext // stride(mix, phy),
            "samples": mix["stream_samples"]}

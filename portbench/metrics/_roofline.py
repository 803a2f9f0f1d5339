"""Roofline arithmetic of the per-layer metrics: the work a cell's shapes
need, the least time the card could take for it, and which device
activities belong to which kernel.

The counts follow from the shapes alone (``generate.shapes``), not from
the kernel that does the work: each input byte read once, each output
byte written once, and the float32 operations of the algorithm (an FFT
counted as 5 n log2 n).  The bound is the larger of the bytes over the
memory rate and the operations over the float32 rate of ``peaks.json``.
"""
from __future__ import annotations

import json
import math
import re
from pathlib import Path

PEAKS = json.loads((Path(__file__).with_name("peaks.json")).read_text())

__all__ = ["PEAKS", "bound_ms", "scan_work", "rx_work", "tx_work",
           "port_kernels", "kernel_ms", "share"]


def bound_ms(nbytes: float, ops: float) -> float:
    return max(nbytes / PEAKS["mem_bytes_per_s"],
               ops / PEAKS["fp32_flops_per_s"]) * 1e3


def scan_work(shapes: dict) -> tuple[float, float]:
    """The stream scan over [tail | chunk]: the samples read once (8 B),
    12 B out per window, the down-chirp once; per window sample the
    down-chirp product (6 flops), the FFT and 5 per bin for |X|^2, the sum
    and the first max."""
    n, windows = shapes["n"], shapes["windows"]
    nbytes = shapes["ext_samples"] * 8 + windows * 12 + n * 8
    return nbytes, windows * n * (6 + 5 + 5 * math.log2(n))


def rx_work(shapes: dict) -> tuple[float, float]:
    """Packet RX: the packets' samples read once, the per-packet shift,
    rate and scale, the multiplier once, 12 B out per window; per window
    sample the scale, rotation and multiplier products (16 flops) and its
    sine and cosine (2), the FFT and 5 per bin."""
    n = shapes["n"]
    windows = shapes["packets"] * shapes["symbols"]
    nbytes = (shapes["samples"] * 8 + shapes["packets"] * 12 + n * 8
              + windows * 12)
    return nbytes, windows * n * (18 + 5 + 5 * math.log2(n))


def tx_work(shapes: dict) -> tuple[float, float]:
    """Packet TX: the samples written once (8 B), the symbols read once
    (4 B), one complex product per sample (6 flops)."""
    samples = shapes["samples"]
    return (samples * 8 + shapes["packets"] * shapes["symbols"] * 4,
            samples * 6)


def port_kernels(port_dir: Path) -> set:
    """The names of the program's own CUDA kernels (``__global__``
    functions of its ``csrc/``)."""
    pattern = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)"
                         r"\s*)?(\w+)\s*\(")
    names = set()
    for src in sorted(port_dir.glob("csrc/*.cu*")):
        names.update(pattern.findall(src.read_text()))
    return names


def kernel_ms(run, match) -> float | None:
    """Device ms per traced call of the program's kernels whose name
    ``match`` accepts; None when none ran."""
    t = run.trace
    if t is None:
        return None
    us = [e - s for name, s, e in t.device
          if any(k in name for k in run.port_kernels) and match(name)]
    return sum(us) / 1e3 / t.calls if us else None


def share(run, work, match) -> float | None:
    """The kernel's share of its roofline, %: the bound over the measured
    device time."""
    ms = kernel_ms(run, match)
    if ms is None:
        return None
    return 100.0 * bound_ms(*work(run.shapes)) / ms

#!/usr/bin/env python3
"""BER/PER-vs-SNR sweep CLI (the ``tests/awgn_sweep.py`` tool the
reference's TEST_PLAN.md:32 promises but does not ship).

PyTorch port of the JAX package's ``runners/awgn_sweep.py``: the same flags
and CSV, plus ``--device {cuda,cpu}`` (default cuda).  Runs
``models.sweep.per_sweep`` (one batch on the device per SNR point) and
writes a CSV; optionally prints an ASCII PER curve.

Usage:
    python -m lora_sdr_lightweight_standalone_library_clean_tpu_torch.runners.awgn_sweep \
        --sf=7 --snr-start=-20 --snr-stop=0 --snr-step=1 \
        --packets=1000 --out=sweep.csv [--plot]
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from .. import LoraParams, sweep
from . import add_device_arg


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="LoRa AWGN BER/PER sweep")
    ap.add_argument("--sf", type=int, default=7)
    ap.add_argument("--bw", type=int, default=125000)
    ap.add_argument("--cr", default="4/5")
    ap.add_argument("--osr", type=int, default=1)
    ap.add_argument("--snr-start", type=float, default=-20.0)
    ap.add_argument("--snr-stop", type=float, default=0.0)
    ap.add_argument("--snr-step", type=float, default=1.0)
    ap.add_argument("--packets", type=int, default=1000)
    ap.add_argument("--bytes", type=int, default=16, dest="nbytes")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--receiver", choices=["tones", "wide"], default="tones",
                    help="wide: sweep demodulate_wide at osr >= bw_scale "
                         "(required for decodable BW-250/500 sweeps)")
    ap.add_argument("--theory", action="store_true",
                    help="append the exact non-coherent SER theory column")
    ap.add_argument("--out", default="-", help="CSV output ('-' = stdout)")
    ap.add_argument("--plot", action="store_true",
                    help="print an ASCII PER-vs-SNR curve to stderr")
    add_device_arg(ap)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.snr_step <= 0:
        print("awgn_sweep: --snr-step must be > 0", file=sys.stderr)
        return 1
    params = LoraParams(sf=args.sf, bw=args.bw, cr=args.cr, osr=args.osr)
    snrs = np.arange(args.snr_start, args.snr_stop + args.snr_step / 2,
                     args.snr_step)
    if snrs.size == 0:
        print("awgn_sweep: empty SNR range (start > stop)", file=sys.stderr)
        return 1
    points = sweep.per_sweep(params, snrs, packets=args.packets,
                             payload_len=args.nbytes, seed=args.seed,
                             receiver=args.receiver, device=args.device)

    if args.theory:
        th = np.atleast_1d(sweep.ser_theory(snrs, args.sf))
        lines = ["snr_db,ser,ber,per,crc_ok_rate,ser_theory"]
        lines += [f"{p.snr_db:g},{p.ser:.6g},{p.ber:.6g},{p.per:.6g},"
                  f"{p.crc_ok_rate:.6g},{t:.6g}"
                  for p, t in zip(points, th)]
    else:
        lines = ["snr_db,ser,ber,per,crc_ok_rate"]
        lines += [f"{p.snr_db:g},{p.ser:.6g},{p.ber:.6g},{p.per:.6g},"
                  f"{p.crc_ok_rate:.6g}" for p in points]
    csv = "\n".join(lines) + "\n"
    if args.out == "-":
        sys.stdout.write(csv)
    else:
        with open(args.out, "w") as f:
            f.write(csv)
        print(f"wrote {len(points)} SNR points to {args.out}",
              file=sys.stderr)

    if args.plot:
        width = 50
        print(f"PER vs SNR (sf={args.sf} bw={args.bw} "
              f"packets={args.packets}):", file=sys.stderr)
        for p in points:
            bar = "#" * int(round(p.per * width))
            print(f"{p.snr_db:7.1f} dB |{bar:<{width}}| {p.per:.3f}",
                  file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

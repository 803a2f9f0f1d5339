"""TX CLI: hex payload -> float32 IQ file (reference: runners/tx_runner.cpp).

PyTorch port of the JAX package's ``runners/tx.py``: the same flags and
output, plus ``--device {cuda,cpu}`` (default cuda).

Usage:
    python -m lora_sdr_lightweight_standalone_library_clean_tpu_torch.runners.tx \
        --payload=DEADBEEF --sf=7 --bw=125000 --cr=4/5 --out=iq.f32
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from .. import LoraParams, encode, encode_frame, modulate, to_complex
from ..utils.tensors import host_device
from . import add_device_arg


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="LoRa TX: hex payload -> IQ")
    ap.add_argument("--payload", required=True, help="hex payload bytes")
    ap.add_argument("--sf", type=int, default=7)
    ap.add_argument("--bw", type=int, default=125000)
    ap.add_argument("--cr", default="4/5")
    ap.add_argument("--osr", type=int, default=1)
    ap.add_argument("--sync", type=lambda v: int(v, 0), default=0x12)
    ap.add_argument("--amplitude", type=float, default=1.0)
    ap.add_argument("--framed", action="store_true",
                    help="full SX1272 frame: explicit header + whitening + "
                         "CR FEC + interleaving + Gray + CRC (models/frame)")
    ap.add_argument("--no-crc", action="store_true",
                    help="omit the payload CRC (framed mode only)")
    ap.add_argument("--out", default="-", help="output file ('-' = stdout)")
    add_device_arg(ap)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    payload = np.frombuffer(bytes.fromhex(args.payload), np.uint8)
    params = LoraParams(sf=args.sf, bw=args.bw, cr=args.cr, osr=args.osr,
                        sync_word=args.sync)
    rows = torch.as_tensor(payload[None].copy(),
                           device=host_device(args.device))
    if args.framed:
        syms = encode_frame(rows, params, crc=not args.no_crc)
    else:
        syms = encode(rows)
    re, im = modulate(syms, params, amplitude=args.amplitude)
    iq = to_complex(re, im)[0]
    inter = np.empty(iq.size * 2, np.float32)
    inter[0::2] = iq.real
    inter[1::2] = iq.imag
    if args.out == "-":
        sys.stdout.buffer.write(inter.tobytes())
    else:
        inter.tofile(args.out)
        print(f"wrote {iq.size} samples ({syms.shape[-1]} data symbols + 2 "
              f"sync) to {args.out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

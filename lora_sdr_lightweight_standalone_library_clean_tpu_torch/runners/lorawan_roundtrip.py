"""LoRaWAN frame roundtrip CLI (reference: runners/lorawan_roundtrip.cpp).

PyTorch port of the JAX package's ``runners/lorawan_roundtrip.py``, plus
``--device {cuda,cpu}`` (default cuda): builds a frame with a fixed
key/devaddr, encodes it to symbols on the device, parses it back and
verifies the payload; exit 0 on success, 1 on mismatch.
"""
from __future__ import annotations

import argparse
import sys

from ..models.lorawan import Frame, MType, build_frame, parse_frame
from . import add_device_arg


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="LoRaWAN build/parse roundtrip")
    ap.add_argument("--payload", default="0102030405060708",
                    help="hex FRMPayload")
    ap.add_argument("--devaddr", type=lambda v: int(v, 0), default=0x01020304)
    ap.add_argument("--fcnt", type=int, default=1)
    add_device_arg(ap)
    args = ap.parse_args(argv)

    key = bytes(range(16))
    frame = Frame()
    frame.mhdr.mtype = MType.UNCONFIRMED_DATA_UP
    frame.fhdr.devaddr = args.devaddr
    frame.fhdr.fcnt = args.fcnt
    frame.payload = bytes.fromhex(args.payload)

    syms = build_frame(key, frame, device=args.device)
    out = parse_frame(key, syms)
    ok = (out.payload == frame.payload
          and out.fhdr.devaddr == frame.fhdr.devaddr
          and out.fhdr.fcnt == frame.fhdr.fcnt)
    print(f"payload={out.payload.hex().upper()} devaddr="
          f"{out.fhdr.devaddr:#010x} fcnt={out.fhdr.fcnt} "
          f"{'OK' if ok else 'MISMATCH'}", file=sys.stderr)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())

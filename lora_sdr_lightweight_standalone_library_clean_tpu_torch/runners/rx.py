"""RX CLI: float32 IQ file -> hex payload (reference: runners/rx_runner.cpp).

PyTorch port of the JAX package's ``runners/rx.py``: the same flags and
output, plus ``--device {cuda,cpu}`` (default cuda).

Usage:
    python -m lora_sdr_lightweight_standalone_library_clean_tpu_torch.runners.rx \
        --in=iq.f32 --sf=7 --bw=125000 [--path=tones|full|wide] [--report-offsets]

``--path=tones`` (default) dechirps then demodulates, the path that decodes
payloads; ``--path=full`` is the reference-faithful full-RX path
(phy.cpp:182-243), whose raw-chirp offset estimation cannot decode its own
modulation (PARITY.md defect 1).
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from .. import (LoraParams, decode, decode_frame, demodulate,
                demodulate_tones, demodulate_wide, dechirp, from_complex)
from . import add_device_arg


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="LoRa RX: IQ -> hex payload")
    ap.add_argument("--in", dest="infile", default="-",
                    help="float32 interleaved IQ file ('-' = stdin)")
    ap.add_argument("--sf", type=int, default=7)
    ap.add_argument("--bw", type=int, default=125000)
    ap.add_argument("--cr", default="4/5")
    ap.add_argument("--osr", type=int, default=1)
    ap.add_argument("--path", choices=["tones", "full", "wide"],
                    default="tones",
                    help="wide: injective osr>=bw_scale receiver for "
                         "BW-250/500 (demodulate_wide), beyond the reference")
    ap.add_argument("--framed", action="store_true",
                    help="decode the SX1272 explicit-header frame "
                         "(whitening + CR FEC + interleaving + Gray + CRC)")
    ap.add_argument("--report-offsets", action="store_true")
    add_device_arg(ap)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        raw = (sys.stdin.buffer.read() if args.infile == "-"
               else open(args.infile, "rb").read())
    except OSError as e:
        print(f"rx: cannot read {args.infile}: {e.strerror}",
              file=sys.stderr)
        return 1
    f = np.frombuffer(raw[: len(raw) - len(raw) % 8], np.float32)
    iq = f[0::2] + 1j * f[1::2]
    params = LoraParams(sf=args.sf, bw=args.bw, cr=args.cr, osr=args.osr)
    usable = (iq.size // params.step) * params.step
    rr, ri = from_complex(iq[:usable][None], device=args.device)
    if args.path == "full":
        res = demodulate(rr, ri, params)
    elif args.path == "wide":
        res = demodulate_wide(*dechirp(rr, ri, params), params)
    else:
        res = demodulate_tones(*dechirp(rr, ri, params), params)
    if args.framed:
        out = decode_frame(res.symbols[0], params)
        if not bool(out.hdr_ok):
            print("rx: header checksum failed", file=sys.stderr)
            return 2
        payload = out.payload[None]
        crc_ok = out.crc_ok[None]
    else:
        nsym = res.symbols.shape[-1] - (res.symbols.shape[-1] % 2)
        payload, crc_ok = decode(res.symbols[..., :nsym])
    print(bytes(payload[0].cpu().numpy()).hex().upper())
    if args.report_offsets:
        print(f"cfo={float(res.cfo[0]):.6g} "
              f"time_offset={float(res.time_offset[0]):.6g} "
              f"sync=0x{int(res.sync_word[0]):02X} "
              f"crc_ok={bool(crc_ok[0])}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

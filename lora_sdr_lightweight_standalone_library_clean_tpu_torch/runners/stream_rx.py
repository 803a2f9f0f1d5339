"""Streaming RX CLI: continuous float32 IQ -> one line per decoded packet.

PyTorch port of the JAX package's ``runners/stream_rx.py``: the same flags
and output, plus ``--device {cuda,cpu}`` (default cuda).  It scans a long
multi-packet capture, recovers every packet at any sample offset and prints
position, CRC verdict and payload, in chunks with carried state, so long
files stream in bounded memory.

Usage:
    python -m lora_sdr_lightweight_standalone_library_clean_tpu_torch.runners.stream_rx \
        --in=capture.f32 --sf=7 --payload-bytes=16 [--chunk=65536] \
        [--max-packets=16] [--bw=...] [--framed]

Output (stdout), one line per packet:
    <start_sample> <crc_ok> <payload_hex>
and, with ``--framed``, `` len=<bytes> hdr_ok=<0|1>`` after it.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from .. import (LoraParams, max_frame_symbols, packet_samples,
                receive_stream, receive_stream_frames, stream_frames_init,
                stream_rx_init)
from ..parallel.receiver import _default_stride, _resolve_wide
from ..utils.tensors import host_device
from . import add_device_arg


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="LoRa streaming RX: multi-packet IQ -> payloads")
    ap.add_argument("--in", dest="infile", default="-",
                    help="float32 interleaved IQ file ('-' = stdin)")
    ap.add_argument("--sf", type=int, default=7)
    ap.add_argument("--bw", type=int, default=125000)
    ap.add_argument("--cr", default="4/5")
    ap.add_argument("--osr", type=int, default=1)
    ap.add_argument("--payload-bytes", type=int, required=True,
                    help="expected payload length (fixed, headerless), or "
                         "the maximum length with --framed")
    ap.add_argument("--framed", action="store_true",
                    help="header-driven variable-length frames "
                         "(receive_stream_frames): each line also reports "
                         "the decoded length and header verdict")
    ap.add_argument("--chunk", type=int, default=65536,
                    help="samples per processing chunk")
    ap.add_argument("--max-packets", type=int, default=16,
                    help="recovery capacity per chunk")
    ap.add_argument("--power-gate-db", type=float, default=5.0)
    ap.add_argument("--wide", choices=["auto", "on", "off"], default="auto",
                    help="injective osr>=bw_scale receiver for BW-250/500 "
                         "streams (demodulate_wide); 'auto' enables it "
                         "when bw_scale > 1 and osr >= bw_scale")
    add_device_arg(ap)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        raw = (sys.stdin.buffer.read() if args.infile == "-"
               else open(args.infile, "rb").read())
    except OSError as e:
        print(f"stream_rx: cannot read {args.infile}: {e.strerror}",
              file=sys.stderr)
        return 1
    dev = host_device(args.device)
    f = np.frombuffer(raw[: len(raw) - len(raw) % 8], np.float32)
    params = LoraParams(sf=args.sf, bw=args.bw, cr=args.cr, osr=args.osr)
    wide = {"auto": None, "on": True, "off": False}[args.wide]
    if args.framed:
        psyms = max_frame_symbols(params, args.payload_bytes)
    else:
        psyms = args.payload_bytes * 2
    plen = packet_samples(params, psyms)

    stride = _default_stride(params, _resolve_wide(params, wide))
    chunk = max(args.chunk, plen) // stride * stride
    # pad the capture to whole chunks so trailing packets complete
    count = f.size // 2
    total = ((count + plen + chunk - 1) // chunk) * chunk
    iq_r = torch.zeros(total, dtype=torch.float32, device=dev)
    iq_i = torch.zeros(total, dtype=torch.float32, device=dev)
    iq_r[:count] = torch.as_tensor(np.ascontiguousarray(f[0::2]), device=dev)
    iq_i[:count] = torch.as_tensor(np.ascontiguousarray(f[1::2]), device=dev)

    state = (stream_frames_init(params, args.payload_bytes, device=dev)
             if args.framed else stream_rx_init(params, psyms, device=dev))
    found = 0
    for lo in range(0, total, chunk):
        part = slice(lo, lo + chunk)
        if args.framed:
            pkts, state = receive_stream_frames(
                iq_r[part], iq_i[part], params,
                max_payload_len=args.payload_bytes,
                max_packets=args.max_packets, state=state,
                power_gate_db=args.power_gate_db, wide=wide)
        else:
            pkts, state = receive_stream(
                iq_r[part], iq_i[part], params, payload_symbols=psyms,
                max_packets=args.max_packets, state=state,
                power_gate_db=args.power_gate_db, wide=wide)
        host = {k: v.cpu().numpy() for k, v in pkts._asdict().items()}
        for k in np.nonzero(host["valid"])[0]:
            start, ok = int(host["start"][k]), int(bool(host["crc_ok"][k]))
            if args.framed:
                ln = int(host["length"][k])
                payload = bytes(host["payload"][k][:ln]).hex().upper()
                print(f"{start} {ok} {payload} len={ln} "
                      f"hdr_ok={int(bool(host['hdr_ok'][k]))}")
            else:
                payload = bytes(host["payload"][k]).hex().upper()
                print(f"{start} {ok} {payload}")
            found += 1
    print(f"stream_rx: {found} packets recovered", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""One continuous stream of raw packets (implicit header) through
``receive_stream``.

Mix keys: those of a stream (``generate.py``), and ``payload_len`` (bytes
a packet, one Hamming(8,4) codeword a nibble; the last two bytes the
SX1272 CRC of bytes 2 .. L-3) and ``altered``.  Packet k sits at
k * pitch + u_k, the pitch being the packet plus its 2 sync symbols plus
``gap_symbols``.
"""
from __future__ import annotations

import torch

from portbench import check, generate
from portbench.reference import rx
from portbench.reference.phy import encode_raw, modulate

NUMBERS = check.STREAM
FAILED = ("missed", "wrong_planted", "false_pass")


def row_symbols(mix: dict, phy) -> int:
    return 2 * mix["payload_len"]


def build(mix: dict, phy, g, dev) -> generate.Input:
    rows = row_symbols(mix, phy)
    count = mix["stream_samples"] // generate.pitch(mix, phy, rows)
    payload, bad = generate.crc_payloads(count, mix["payload_len"],
                                         mix["altered"], g, dev)
    re, im = modulate(encode_raw(payload), phy)
    flen = torch.full((count,), re.shape[1], device=dev)
    sr, si, starts = generate.stream(re, im, flen, mix, phy, rows, g, dev)
    truth = {"start": starts, "payload": payload, "altered": bad}
    return generate.Input((sr, si), truth, count, sr.shape[0])


def shapes(mix: dict, phy) -> dict:
    return generate.stream_shapes(mix, phy, row_symbols(mix, phy))


def entry(lora, params, mix: dict, phy):
    rows = row_symbols(mix, phy)
    kw = {"payload_symbols": rows,
          "max_packets": generate.slots(mix, phy, rows),
          "stride": generate.stride(mix, phy),
          "power_gate_db": float(mix["power_gate_db"])}

    def call(inp):
        out, _ = lora.receive_stream(*inp.args, params, **kw)
        return out
    return call


outputs = check.stream_rows


def reference(mix: dict, phy, inp, prec: str) -> dict:
    return rx.receive(*inp.args, phy, frames=False,
                      payload_len=mix["payload_len"],
                      max_packets=generate.slots(mix, phy,
                                                 row_symbols(mix, phy)),
                      stride=generate.stride(mix, phy),
                      gate_db=float(mix["power_gate_db"]), prec=prec)


def compare(got: dict, ref: dict, truth: dict, mix: dict, phy) -> dict:
    return check.stream(got, ref, truth, phy, False,
                        generate.stride(mix, phy))

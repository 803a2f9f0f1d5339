"""One continuous stream of SX1272 frames (explicit header, payload CRC)
through ``receive_stream_frames``.

Mix keys: those of a stream (``generate.py``), and ``max_payload_len``
(the receiver's bound), ``length_min`` .. ``length_max`` (frame lengths,
uniform), ``altered`` (frames with a byte changed after their CRC).
Frame k sits at k * pitch + u_k, the pitch being the maximal frame plus
its 2 sync symbols plus ``gap_symbols``.
"""
from __future__ import annotations

import torch

from portbench import check, generate
from portbench.reference import rx
from portbench.reference.phy import encode_frame, frame_symbols, modulate

NUMBERS = check.STREAM
FAILED = ("missed", "wrong_planted", "false_pass")


def row_symbols(mix: dict, phy) -> int:
    return frame_symbols(phy, mix["max_payload_len"])


def build(mix: dict, phy, g, dev) -> generate.Input:
    max_len = mix["max_payload_len"]
    s_max = row_symbols(mix, phy)
    count = mix["stream_samples"] // generate.pitch(mix, phy, s_max)
    lengths = torch.randint(mix["length_min"], mix["length_max"] + 1,
                            (count,), generator=g, device=dev)
    original = torch.randint(0, 256, (count, max_len), generator=g,
                             device=dev)
    original *= torch.arange(max_len, device=dev) < lengths[:, None]
    payload = original.clone()
    bad = generate.alter(payload, lengths, mix["altered"], g)
    syms = torch.zeros(count, s_max, dtype=torch.int64, device=dev)
    nsym = torch.zeros(count, dtype=torch.int64, device=dev)
    for length in range(mix["length_min"], mix["length_max"] + 1):
        rows = torch.nonzero(lengths == length).flatten()
        if rows.numel() == 0:
            continue
        s = encode_frame(payload[rows, :length], phy,
                         crc_of=original[rows, :length])
        syms[rows, :s.shape[1]] = s
        nsym[rows] = s.shape[1]
    re, im = modulate(syms, phy)
    sr, si, starts = generate.stream(re, im, (nsym + 2) * phy.step, mix,
                                     phy, s_max, g, dev)
    truth = {"start": starts, "payload": payload, "length": lengths,
             "altered": bad}
    return generate.Input((sr, si), truth, count, sr.shape[0])


def shapes(mix: dict, phy) -> dict:
    return generate.stream_shapes(mix, phy, row_symbols(mix, phy))


def entry(lora, params, mix: dict, phy):
    rows = row_symbols(mix, phy)
    kw = {"max_payload_len": mix["max_payload_len"],
          "max_packets": generate.slots(mix, phy, rows),
          "stride": generate.stride(mix, phy),
          "power_gate_db": float(mix["power_gate_db"])}

    def call(inp):
        out, _ = lora.receive_stream_frames(*inp.args, params, **kw)
        return out
    return call


outputs = check.stream_rows


def reference(mix: dict, phy, inp, prec: str) -> dict:
    return rx.receive(*inp.args, phy, frames=True,
                      payload_len=mix["max_payload_len"],
                      max_packets=generate.slots(mix, phy,
                                                 row_symbols(mix, phy)),
                      stride=generate.stride(mix, phy),
                      gate_db=float(mix["power_gate_db"]), prec=prec)


def compare(got: dict, ref: dict, truth: dict, mix: dict, phy) -> dict:
    return check.stream(got, ref, truth, phy, True,
                        generate.stride(mix, phy))

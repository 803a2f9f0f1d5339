"""A batch of raw packets through the whole PHY: ``encode ->
modulate_dechirped -> demodulate_tones -> decode``.

Mix keys: ``samples_per_call`` (the air a call's packets fill),
``payload_len`` (bytes a packet; the last two the SX1272 CRC of bytes
2 .. L-3) and ``altered``.
"""
from __future__ import annotations

import torch

from portbench import check, generate
from portbench.reference import rx

NUMBERS = check.BATCH
FAILED = ("wrong_rows",)


def _symbols(mix: dict) -> int:
    return 2 * mix["payload_len"] + 2


def build(mix: dict, phy, g, dev) -> generate.Input:
    samples = _symbols(mix) * phy.step
    count = mix["samples_per_call"] // samples
    payload, bad = generate.crc_payloads(count, mix["payload_len"],
                                         mix["altered"], g, dev)
    return generate.Input((payload.to(torch.uint8),),
                          {"payload": payload, "altered": bad},
                          count, count * samples)


def shapes(mix: dict, phy) -> dict:
    symbols = _symbols(mix)
    packets = mix["samples_per_call"] // (symbols * phy.step)
    return {"n": phy.n, "packets": packets, "symbols": symbols,
            "samples": packets * symbols * phy.step}


def entry(lora, params, mix: dict, phy):
    def call(inp):
        syms = lora.encode(inp.args[0])
        dr, di = lora.modulate_dechirped(syms, params)
        res = lora.demodulate_tones(dr, di, params)
        payload, crc_ok = lora.decode(res.symbols)
        return {"dr": dr, "di": di, "symbols": res.symbols,
                "sync_word": res.sync_word, "cfo": res.cfo,
                "time_offset": res.time_offset, "power": res.power,
                "power_avg": res.power_avg, "payload": payload,
                "crc_ok": crc_ok}
    return call


def outputs(out) -> dict:
    return out


def reference(mix: dict, phy, inp, prec: str) -> dict:
    return rx.packet_batch(inp.truth["payload"], phy, prec)


def compare(got: dict, ref: dict, truth: dict, mix: dict, phy) -> dict:
    return check.batch(got, ref, truth, phy)

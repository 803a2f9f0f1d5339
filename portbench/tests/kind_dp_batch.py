"""A kind of traffic for the tests of runs across ranks (``ranks.py``),
never a cell of the benchmark: ``packet_batch``'s PHY on a batch sharded
over the ranks' channel axis (the port's ``global_mesh`` and
``channel_sharding``), each rank running its own chunk, then the decoded
bytes and CRC verdicts gathered to every rank (``allgather``): one
collective a call.  The tests copy it into a benchmark root's ``kinds/``.

Mix keys: ``packet_batch``'s; and for the tests' planted faults
``fault`` ("alter": one byte of the gathered bytes; "raise"; "sleep": far
past any deadline) on rank ``fault_rank`` from its ``fault_call``-th call
(warm-up included) on.
"""
from __future__ import annotations

import importlib
import time

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

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
    par = importlib.import_module(lora.__name__ + ".parallel.distributed")
    mesh = par.global_mesh(
        device="cuda" if dist.get_backend() == "nccl" else "cpu")
    sharding = par.channel_sharding(mesh)
    coord = mesh.get_coordinate()
    chunk = coord[0] * mesh.size(1) + coord[1]
    faulty = "fault" in mix and dist.get_rank() == mix["fault_rank"]
    made = [0]

    def call(inp):
        made[0] += 1
        if faulty and made[0] >= mix["fault_call"]:
            if mix["fault"] == "raise":
                raise RuntimeError("a planted fault")
            if mix["fault"] == "sleep":
                time.sleep(3600)
        local = par.make_global_array(inp.args[0], sharding).to_local()
        syms = lora.encode(local)
        dr, di = lora.modulate_dechirped(syms, params)
        res = lora.demodulate_tones(dr, di, params)
        payload, crc_ok = lora.decode(res.symbols)
        both = torch.cat([payload.to(torch.uint8),
                          crc_ok[:, None].to(torch.uint8)], 1)
        every = torch.as_tensor(par.allgather(DTensor.from_local(
            both, mesh, sharding, run_check=False)))
        if faulty and mix["fault"] == "alter" \
                and made[0] >= mix["fault_call"]:
            every[0, 0] ^= 1
        lo = chunk * local.shape[0]
        return {"payload": every[:, :-1], "crc_ok": every[:, -1].bool(),
                "rows": (lo, lo + local.shape[0]), "dr": dr, "di": di,
                "symbols": res.symbols, "sync_word": res.sync_word,
                "power": res.power}
    return call


def outputs(out) -> dict:
    return out


def reference(mix: dict, phy, inp, prec: str) -> dict:
    return rx.packet_batch(inp.truth["payload"], phy, prec)


def compare(got: dict, ref: dict, truth: dict, mix: dict, phy) -> dict:
    """``check.batch``'s numbers: the gathered bytes and verdicts of every
    row, and this rank's own rows of the rest."""
    dev = ref["payload"].device
    lo, hi = got["rows"]
    pay = got["payload"].to(dev).to(torch.int64)
    ok = got["crc_ok"].to(dev)
    wrong = (pay != ref["payload"]).any(1) | (pay != truth["payload"]).any(1)
    wrong |= (ok != ref["crc_ok"]) | (ok == truth["altered"])
    sync = got["sync_word"].to(dev).to(torch.int64)
    wrong[lo:hi] |= (got["symbols"].to(dev).to(torch.int64)
                     != ref["symbols"][lo:hi]).any(1)
    wrong[lo:hi] |= (sync != ref["sync_word"][lo:hi]) | (sync != phy.sync_word)
    tx = max(float((got[k].to(dev).to(torch.float64) - ref[k][lo:hi])
                   .abs().max()) for k in ("dr", "di"))
    db = float((got["power"].to(dev).to(torch.float64)
                - ref["power"][lo:hi].to(torch.float64)).abs().max())
    return {"wrong_rows": int(wrong.sum()), "tx_gap": tx, "db_gap": db}

"""The harness end to end on the CPU, at tiny sizes: found by name, sound
runs correct, the control and each planted fault not."""
from __future__ import annotations

import json
import time

import pytest
import torch

from portbench import control, spec
from portbench import run as bench_run

CELLS = ("sf7-gateway-frames", "sf7-gateway-sparse", "sf12-stream-packets",
         "sf7-packet-batch", "sf12-packet-batch")


def _run(root, cell, wrap=None, traced=False, seed=20250101):
    c = spec.load(cell, root)
    return bench_run.run_cell(c, seed, 0.3, traced, "cpu",
                              start=time.perf_counter(), wrap=wrap)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(tiny_root, cell):
    res = _run(tiny_root, cell)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert list(res)[-1] == "checks"
    want = {m["name"] for m in spec.load(cell, tiny_root).end_to_end}
    assert set(res["metrics"]) == want
    assert all(m["value"] > 0 for m in res["metrics"].values())


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(tiny_root, cell):
    c = spec.load(cell, tiny_root)
    got = control.readings(c, 7, "cpu", control=True)
    assert not got["passes_limits"], got
    assert control.readings(c, 7, "cpu", control=False)["passes_limits"]


def _altered(entry):
    """An answer altered where it is produced: one byte of one packet."""
    def call(inp):
        out = entry(inp)
        pay = out["payload"] if isinstance(out, dict) else out.payload
        pay[0, 0] ^= 1
        return out
    return call


def _half(entry):
    """Half of the batch left out: the call sees only the first half of
    its stream or of its packets."""
    def call(inp):
        args = tuple(a[:a.shape[0] // 2] for a in inp.args)
        out = entry(inp._replace(args=args))
        if isinstance(out, dict):
            rows = inp.args[0].shape[0]
            out = {k: (torch.cat([v, torch.zeros_like(v)])[:rows]
                       if v.ndim and v.shape[0] == rows // 2 else v)
                   for k, v in out.items()}
        return out
    return call


def _stale(entry):
    """A call that returns what the one before it returned (the state
    left unchanged)."""
    last = []

    def call(inp):
        out = entry(inp)
        last.append(out)
        return last[-2] if len(last) > 1 else out
    return call


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", (_altered, _half, _stale))
def test_planted_fault_is_not_correct(tiny_root, cell, fault):
    res = _run(tiny_root, cell, wrap=fault)
    assert not res["correct"], res["checks"]


def test_new_files_are_found_by_name(tiny_root):
    """A configuration, a traffic mix, a metric and a cell added as new
    files and entries, with no existing file edited."""
    pb = tiny_root / "portbench"
    cfg = json.loads((pb / "configs" / "eu868-dr5-sf7bw125.json").read_text())
    cfg.update(name="eu868-dr4-sf8bw125", sf=8)
    (pb / "configs" / "eu868-dr4-sf8bw125.json").write_text(json.dumps(cfg))
    mix = json.loads((pb / "traffic" / "packet-batch.json").read_text())
    mix.update(samples_per_call=16896 * 8, payload_len=32)
    (pb / "traffic" / "small-batch.json").write_text(json.dumps(mix))
    (pb / "limits" / "sf8-small-batch.json").write_text(
        (pb / "limits" / "sf7-packet-batch.json").read_text())
    (pb / "metrics" / "calls_traced.py").write_text(
        "def read(run):\n    return float(run.trace.calls)\n")
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "eu868-dr4-sf8bw125", "source": "x",
                             "file": "portbench/configs/eu868-dr4-sf8bw125.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "sf8-small-batch",
                               "config": "eu868-dr4-sf8bw125",
                               "traffic": "small-batch", "chips": 1,
                               "why": "x"})
    bench["per_layer"].append({"name": "calls_traced", "unit": "calls",
                               "better": "higher", "source": "host_clock",
                               "layer": "device", "moves": "pkts_per_s",
                               "workloads": ["sf8-small-batch"]})
    for m in bench["end_to_end"]:
        if m["name"] == "pkts_per_s":
            m["workloads"].append("sf8-small-batch")
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    c = spec.load("sf8-small-batch", tiny_root)
    assert c.config["sf"] == 8 and c.mix["samples_per_call"] == 16896 * 8
    assert "pkts_per_s" in {m["name"] for m in c.end_to_end}
    res = _run(tiny_root, "sf8-small-batch", traced=True)
    assert res["correct"], res["checks"]
    assert res["metrics"]["calls_traced"]["value"] == bench_run.TRACED_CALLS
    assert res["attempted"] % 8 == 0


# a kind of traffic the benchmark does not have: TX alone, compared with
# the reference modulator
TX_KIND = """
import torch
from portbench import generate
from portbench.reference.phy import encode_raw, modulate

NUMBERS = ("tx_gap",)
FAILED = ()


def _samples(mix, phy):
    return mix["packets"] * (2 * mix["payload_len"] + 2) * phy.step


def build(mix, phy, g, dev):
    payload, _ = generate.crc_payloads(mix["packets"], mix["payload_len"],
                                       0, g, dev)
    return generate.Input((payload.to(torch.uint8),), {"payload": payload},
                          mix["packets"], _samples(mix, phy))


def shapes(mix, phy):
    return {"n": phy.n, "samples": _samples(mix, phy)}


def entry(lora, params, mix, phy):
    def call(inp):
        dr, di = lora.modulate_dechirped(lora.encode(inp.args[0]), params)
        return {"dr": dr, "di": di}
    return call


def outputs(out):
    return out


def reference(mix, phy, inp, prec):
    dr, di = modulate(encode_raw(inp.truth["payload"]), phy, dechirped=True,
                      prec=prec)
    return {"dr": dr, "di": di}


def compare(got, ref, truth, mix, phy):
    return {"tx_gap": max(float((got[k].double() - ref[k].double()).abs()
                                .max()) for k in ("dr", "di"))}
"""


def test_new_kind_is_found_by_name(tiny_root):
    """A kind of traffic added as a new file, with its mix, limits and
    cell: found by name, correct, and a corrupted TX output caught."""
    pb = tiny_root / "portbench"
    (pb / "kinds" / "tx_batch.py").write_text(TX_KIND)
    (pb / "traffic" / "tx-batch.json").write_text(json.dumps(
        {"kind": "tx_batch", "packets": 6, "payload_len": 16, "pool": 2}))
    (pb / "limits" / "sf7-tx-batch.json").write_text(
        json.dumps({"tx_gap": 2e-6}))
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "sf7-tx-batch",
                               "config": "eu868-dr5-sf7bw125",
                               "traffic": "tx-batch", "chips": 1,
                               "why": "x"})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    c = spec.load("sf7-tx-batch", tiny_root)
    assert c.kind.NUMBERS == ("tx_gap",)
    res = _run(tiny_root, "sf7-tx-batch")
    assert res["correct"], res["checks"]
    assert res["attempted"] % 6 == 0 and res["failed"] == 0

    def corrupt(entry):
        def call(inp):
            out = entry(inp)
            out["dr"][0, 0] += 1e-3
            return out
        return call
    assert not _run(tiny_root, "sf7-tx-batch", wrap=corrupt)["correct"]

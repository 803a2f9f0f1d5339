"""Runs across ranks (``ranks.py``) on the CPU: gloo ranks, each a process
as ``torchrun`` starts them, on a test-only kind of traffic
(``kind_dp_batch.py``: a packet batch sharded over the ranks, one
collective a call) in a tiny copy of the benchmark; and a cell of one
chip, which stays in its process with no process group."""
from __future__ import annotations

import json
import re
import shutil
import time
from pathlib import Path

import pytest
import torch
import torch.distributed as dist

from portbench import ranks, spec
from portbench import run as bench_run

HERE = Path(__file__).resolve().parent
CELL = "sf7-dp-batch"
SEED = 2 ** 31 + 901
SECONDS = 0.5
FAULT_CALL = 14     # in the window: set-up makes 2 x 2 + 7 calls


def _root(root: Path, chips: int, **fault) -> Path:
    """``root`` with the kind, its mix (the packet-batch mix), limits and
    a cell of ``chips`` ranks that reports what sf7-packet-batch does."""
    pb = root / "portbench"
    shutil.copy(HERE / "kind_dp_batch.py", pb / "kinds" / "dp_batch.py")
    mix = json.loads((pb / "traffic" / "packet-batch.json").read_text())
    mix.update(kind="dp_batch", **fault)
    (pb / "traffic" / "dp-batch.json").write_text(json.dumps(mix))
    shutil.copy(pb / "limits" / "sf7-packet-batch.json",
                pb / "limits" / f"{CELL}.json")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": CELL, "config": "eu868-dr5-sf7bw125",
                               "traffic": "dp-batch", "chips": chips,
                               "why": "x"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "sf7-packet-batch" in m.get("workloads", ()):
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def _launch(root: Path, traced: bool = False):
    t0 = time.perf_counter()
    res = ranks.launch(spec.load(CELL, root), SEED, SECONDS, traced,
                       backend="gloo")
    return res, time.perf_counter() - t0


def _left_running(root: Path) -> list:
    """Processes whose command line names ``root``: ranks left behind."""
    found = []
    for cmdline in Path("/proc").glob("[0-9]*/cmdline"):
        try:
            if str(root).encode() in cmdline.read_bytes():
                found.append(cmdline.parent.name)
        except OSError:
            pass
    return found


@pytest.mark.parametrize("chips,traced", [(2, False), (4, False),
                                          (2, True)])
def test_ranks_run_in_lockstep(tiny_root, chips, traced, capfd):
    one = bench_run.run_cell(spec.load("sf7-packet-batch", tiny_root), SEED,
                             0.2, traced, "cpu")
    root = _root(tiny_root, chips)
    res, _ = _launch(root, traced)
    err = capfd.readouterr().err
    assert res is not None, err[-3000:]
    assert res["correct"], res["checks"]
    assert res["failed"] == 0
    assert list(res) == list(one)
    assert list(res["device"]) == list(one["device"]) + ["per_rank"]
    assert res["device"]["count"] == chips
    assert [r["kind"] for r in res["device"]["per_rank"]] == ["cpu"] * chips
    assert set(res["metrics"]) == set(one["metrics"]) or traced
    if traced:
        assert "host_ms_per_call" in res["metrics"]
        assert res["device"]["busy_s"] >= 0 and res["device"]["window_s"] > 0
    else:
        assert all(m["value"] > 0 for m in res["metrics"].values())
    # every rank made the window's calls, the same number
    calls = dict(re.findall(
        rf"portbench: {CELL} seed {SEED} \(rank (\d) of {chips}\): "
        r"set-up [\d.]+ s, (\d+) calls", err))
    assert sorted(calls) == [str(r) for r in range(chips)], err[-3000:]
    assert set(calls.values()) == {str(res["calls"])}
    assert res["attempted"] == 64 * res["calls"]
    assert not _left_running(root)


def test_an_altered_byte_on_one_rank_is_not_correct(tiny_root):
    root = _root(tiny_root, 2, fault="alter", fault_rank=1, fault_call=1)
    res, _ = _launch(root)
    assert res is not None and not res["correct"]
    assert res["checks"]["wrong_rows"]["value"] >= 1


def test_a_rank_that_raises_ends_the_run(tiny_root, capfd):
    root = _root(tiny_root, 4, fault="raise", fault_rank=2,
                 fault_call=FAULT_CALL)
    res, seconds = _launch(root)
    err = capfd.readouterr().err
    assert res is None
    assert "a planted fault" in err and "rank 2 exited with 1" in err
    assert seconds < ranks.deadline_s(SECONDS) / 2
    assert not _left_running(root)


def test_a_rank_past_the_deadline_ends_every_rank(tiny_root, monkeypatch,
                                                  capfd):
    monkeypatch.setattr(ranks, "SETUP_ALLOWANCE_S", 25.0)
    monkeypatch.setattr(ranks, "CHECK_ALLOWANCE_S", 5.0)
    root = _root(tiny_root, 2, fault="sleep", fault_rank=1,
                 fault_call=FAULT_CALL)
    res, seconds = _launch(root)
    assert res is None
    assert "the deadline passed" in capfd.readouterr().err
    limit = ranks.deadline_s(SECONDS)
    assert limit <= seconds < limit + ranks.GRACE_S + 5
    assert not _left_running(root)


def test_a_cell_of_one_chip_starts_no_rank(tiny_root, monkeypatch, capsys):
    """``main`` on a cell of one chip: the run stays in this process, no
    process group is initialised, and the result is a one-chip run's."""
    def refuse(*a, **kw):
        raise AssertionError("a cell of one chip started ranks")
    monkeypatch.setattr(dist, "init_process_group", refuse)
    monkeypatch.setattr(ranks, "launch", refuse)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch, "set_num_threads", lambda n: None)
    load = spec.load
    monkeypatch.setattr(spec, "load", lambda name: load(name, tiny_root))
    run_cell = bench_run.run_cell
    monkeypatch.setattr(bench_run, "run_cell",
                        lambda cell, seed, seconds, traced, device:
                        run_cell(cell, seed, seconds, traced, "cpu"))
    assert bench_run.main(["--workload", "sf7-packet-batch", "--seed",
                           str(SEED), "--seconds", "0.2"]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert not dist.is_initialized()
    assert res["correct"]
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "calls", "checks"]
    assert list(res["device"]) == ["platform", "kind", "count",
                                   "memory_peak_bytes", "power_limit_w"]
    assert res["device"]["count"] == 1

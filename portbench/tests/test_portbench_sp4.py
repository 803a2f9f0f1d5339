"""The four-card cell ``sf7-gateway-frames-sp4`` on the CPU: its kind
(``kinds/stream_frames_sp.py``) on four gloo ranks, each a process as
``ranks.py`` starts them, at a tiny size, judged against the float64
reference through the kind's comparison; and its three readers
(``collective_ms``, ``collective_mb_per_call``, ``rank_scan_roofline``)
on recorded windows."""
from __future__ import annotations

import importlib
import json
import math
import sys
import types
from types import SimpleNamespace

import pytest

from portbench import control, program, ranks, spec, trace
from portbench.metrics import _stages
from portbench.spec import ROOT, Cell, reader

CELL = "sf7-gateway-frames-sp4"
CONFIG = "eu868-dr5-sf7bw125-sp4"
SEED = 2 ** 31 + 4242
# the mix cut to 16 frames of up to 16 B in 5,376 x 16 samples: each
# rank's block is shorter than a frame's row, so frames straddle blocks
TINY = {"stream_samples": 5376 * 16, "max_payload_len": 16,
        "length_min": 4, "length_max": 16, "altered": 3}
# as the one-card cell's tiny copy (conftest.TINY_LIMITS)
TINY_LIMITS = {"est_moved": 34.0}
# the per-layer metrics the cell reports: GF7's that read a rank's trace
# correctly, and its own three
READ = ("device_idle_share", "launches_per_call", "host_ms_per_call",
        "torch_kernels_ms", "candidates_per_pkt", "extract_ms", "select_ms",
        "estimate_ms", "codec_ms", "program_idle_ms", "syncs_per_call")
OWN = ("collective_ms", "collective_mb_per_call", "rank_scan_roofline")


def _tiny(root):
    """``root`` with the cell's mix cut to TINY and its limits to
    TINY_LIMITS (the shared fixture cuts the one-card cells' mixes)."""
    pb = root / "portbench"
    mix = json.loads((ROOT / "portbench" / "traffic"
                      / "gateway-frames-sp4.json").read_text())
    mix.update(TINY)
    (pb / "traffic" / "gateway-frames-sp4.json").write_text(json.dumps(mix))
    path = pb / "limits" / f"{CELL}.json"
    path.write_text(json.dumps({**json.loads(path.read_text()),
                                **TINY_LIMITS}))
    return root


def test_the_cell_is_found_by_name(tiny_root):
    c = spec.load(CELL, _tiny(tiny_root))
    assert c.chips == 4 and c.config["name"] == CONFIG
    assert c.kind.__name__.endswith("stream_frames_sp")
    full = json.loads((ROOT / "portbench" / "traffic"
                       / "gateway-frames-sp4.json").read_text())
    assert full["stream_samples"] % (full["sp"] * 32) == 0
    assert {m["name"] for m in c.per_layer} == set(READ) | set(OWN)
    assert {m["name"] for m in c.end_to_end} == {"call_p95_ms",
                                                 "air_s_per_s", "setup_s"}


@pytest.mark.parametrize("traced", [False, True])
def test_four_ranks_are_correct_against_the_reference(tiny_root, traced,
                                                      capfd):
    root = _tiny(tiny_root)
    res = ranks.launch(spec.load(CELL, root), SEED, 0.5, traced,
                       backend="gloo")
    err = capfd.readouterr().err
    assert res is not None, err[-3000:]
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["device"]["count"] == 4
    assert set(res["checks"]) == {"missed", "wrong_planted", "false_pass",
                                  "cand_diff", "est_moved"}
    if not traced:
        assert set(res["metrics"]) == {"call_p95_ms", "air_s_per_s",
                                       "setup_s"}
        return
    # on the CPU the collectives launch no device kernel and no scan
    # kernel runs: the collectives' device ms read 0, the roofline is
    # silent, the counter reads what each rank puts in; every rank's
    # stage table holds the three collective spans
    assert res["metrics"]["collective_ms"]["value"] == 0.0
    assert "rank_scan_roofline" not in res["metrics"]
    assert res["metrics"]["collective_mb_per_call"]["value"] > 0
    for kind in ("halo", "scan", "results"):
        assert err.count(f"lora.rx.collective.{kind}") == 4, err[-3000:]


def test_the_control_is_not_correct(tiny_root):
    c = spec.load(CELL, _tiny(tiny_root))
    assert not control.readings(c, 7, "cpu", control=True)["passes_limits"]


def test_a_program_without_the_local_block_entry_fails_at_once(tiny_root):
    """A program without ``stream_block`` cannot run the cell: the kind's
    entry raises before it builds a mesh or sees an input."""
    lora = types.ModuleType("lora_without_blocks")
    par = types.ModuleType("lora_without_blocks.parallel.distributed")

    def refuse(*a, **kw):
        raise AssertionError("a mesh was built")
    par.global_mesh = refuse
    sys.modules[par.__name__] = par
    try:
        with pytest.raises(AttributeError, match="stream_block"):
            spec.load(CELL, _tiny(tiny_root)).kind.entry(lora, None, {},
                                                            None)
    finally:
        del sys.modules[par.__name__]


# a call of the sharded receiver: its root, the three stages that hold a
# collective, each collective's span; the NCCL kernels (correlation ids
# 1-3) and a copy (4) launched in the halo span run on the card after
# their launches; a kernel (5) launched after the results' span closed
# is in none
SPANS = [("lora.receive_stream_frames", 0, 1000),
         ("lora.rx.extend", 10, 100), ("lora.rx.collective.halo", 20, 30),
         ("lora.rx.scan", 100, 300), ("lora.rx.collective.scan", 200, 210),
         ("lora.rx.outputs", 800, 900),
         ("lora.rx.collective.results", 850, 860)]
RUNTIME = [("cuLaunchKernelEx", 22, 23, 1), ("cuLaunchKernelEx", 202, 203, 2),
           ("cuLaunchKernelEx", 852, 853, 3), ("cudaMemcpyAsync", 25, 26, 4),
           ("cuLaunchKernelEx", 950, 951, 5)]
DEVICE = [("ncclDevKernel_AllGather_RING_LL", 40, 90, 1),
          ("ncclDevKernel_AllGather_RING_LL", 300, 500, 2),
          ("ncclDevKernel_AllReduce_Sum_u32_RING_LL", 900, 930, 3),
          ("Memcpy DtoD (Device -> Device)", 90, 95, 4),
          ("ncclDevKernel_AllReduce_Sum_u32_RING_LL", 960, 970, 5)]


def test_collective_ms_on_a_recorded_window():
    """The device ms launched inside the collective spans, from
    ``_stages``' analysis: the three NCCL kernels, not the kernel launched
    after the results' span closed."""
    w = _stages.Window(SPANS, RUNTIME, DEVICE, 1, (0.0, 1000.0), [1.0])
    run = SimpleNamespace(lora_stages=_stages.analyse(w))
    assert reader(_cell(), "collective_ms")(run) == pytest.approx(
        0.05 + 0.2 + 0.03 + 0.005)


def test_collective_mb_per_call_counts_one_further_call():
    counts = importlib.import_module(program.PORT + ".utils.spans").COUNTS

    def call():
        counts["collective_bytes.halo"] += 4000
        counts["collective_bytes.scan"] += 2_000_000
        counts["launch.stream_scan"] += 1
    run = SimpleNamespace(trace=object(), call=call,
                          device=SimpleNamespace(type="cpu"))
    assert reader(_cell(), "collective_mb_per_call")(run) == pytest.approx(
        2.004)


def test_collective_readers_are_silent_without_spans_or_bytes():
    w = _stages.Window([("lora.receive_stream_frames", 0, 1000)], RUNTIME,
                       DEVICE, 1, (0.0, 1000.0), [1.0])
    run = SimpleNamespace(lora_stages=_stages.analyse(w))
    assert reader(_cell(), "collective_ms")(run) is None
    quiet = SimpleNamespace(trace=object(), call=lambda: None,
                            device=SimpleNamespace(type="cpu"))
    assert reader(_cell(), "collective_mb_per_call")(quiet) is None
    idle = SimpleNamespace(trace=None, call=None)
    assert reader(_cell(), "collective_mb_per_call")(idle) is None


def _cell():
    return Cell("x", 4, {}, {}, {}, [], [], ROOT)


def test_rank_scan_roofline_counts_rank_zeros_share():
    """The scan kernel's time against the windows of rank 0's block and
    the carried tail: a quarter of the call's samples plus a row."""
    shapes = {"n": 128, "stride": 32, "row_samples": 44800,
              "samples": 1 << 22, "sp": 4, "windows": 10 ** 9,
              "ext_samples": 10 ** 9}
    dev = [("void rx_dense_kernel<128, lora_rx::StreamReader>(float)", 0,
            400),
           ("ncclDevKernel_AllGather_RING_LL", 400, 900)]
    run = SimpleNamespace(trace=trace.Trace(dev, [], 2, (0.0, 1000.0)),
                          shapes=shapes, port_kernels={"rx_dense_kernel"})
    ext = 44800 + (1 << 20)
    windows = ext // 32
    bound = max((ext * 8 + windows * 12 + 128 * 8) / 3.35e12,
                windows * 128 * (11 + 5 * math.log2(128)) / 6.7e13) * 1e3
    assert reader(_cell(), "rank_scan_roofline")(run) == pytest.approx(
        100 * bound / 0.2)
    del shapes["sp"]
    assert reader(_cell(), "rank_scan_roofline")(run) is None

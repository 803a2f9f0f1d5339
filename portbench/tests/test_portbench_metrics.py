"""The per-layer arithmetic on a fabricated trace: idle share, launches,
torch kernel time, rooflines, and the breakdown's idle gaps named by the
host operation open in them."""
from __future__ import annotations

import math
from types import SimpleNamespace

import pytest

from portbench import trace
from portbench.metrics import _roofline
from portbench.spec import ROOT, Cell, reader

PORT = {"rx_dense_kernel", "tx_dense_kernel"}
# two calls over 0 .. 1000 us: device busy 0-100, 150-250 (two kernels
# overlapping 200-250 on two streams), 600-700
DEVICE = [("void rx_dense_kernel<128, lora_rx::StreamReader>(float)", 0, 100),
          ("Memcpy DtoD (Device -> Device)", 150, 250),
          ("void at::native::vectorized_elementwise_kernel<4>", 200, 250),
          ("void rx_dense_kernel<128, lora_rx::DirectReader>(float)", 600, 650),
          ("tx_dense_kernel(int const*)", 650, 700)]
HOST = [("aten::topk", 90, 400), ("cudaStreamSynchronize", 260, 390),
        ("aten::index_select", 700, 900)]
SHAPES_STREAM = {"n": 128, "ext_samples": 1 << 20, "windows": 1 << 15}
SHAPES_BATCH = {"n": 128, "packets": 64, "symbols": 66,
                "samples": 64 * 66 * 128}


def _run(shapes):
    tr = trace.Trace(DEVICE, HOST, 2, (0.0, 1000.0))
    return SimpleNamespace(trace=tr, host_ms=[2.0, 4.0], shapes=shapes,
                           planted=4, port_kernels=PORT,
                           outputs=[{"start": list(range(6))},
                                    {"start": list(range(4))}])


def _cell():
    return Cell("x", 1, {}, {}, {}, [], [], ROOT)


def test_busy_union_and_idle_share():
    run = _run(SHAPES_STREAM)
    assert trace.busy_intervals(run.trace) == [(0, 100), (150, 250),
                                                (600, 700)]
    assert reader(_cell(), "device_idle_share")(run) == pytest.approx(70.0)


def test_launches_host_and_torch_kernel_time():
    run = _run(SHAPES_STREAM)
    assert reader(_cell(), "launches_per_call")(run) == 2.5
    assert reader(_cell(), "host_ms_per_call")(run) == 3.0
    # the copy (100 us) and the elementwise kernel (50 us), over 2 calls
    assert reader(_cell(), "torch_kernels_ms")(run) == pytest.approx(0.075)


def test_rooflines_from_shapes():
    run = _run(SHAPES_STREAM)
    n, w = 128, 1 << 15
    nbytes = (1 << 20) * 8 + w * 12 + n * 8
    ops = w * n * (11 + 5 * math.log2(n))
    bound = max(nbytes / 3.35e12, ops / 6.7e13) * 1e3
    assert reader(_cell(), "scan_roofline")(run) == pytest.approx(
        100 * bound / 0.05)
    run = _run(SHAPES_BATCH)
    samples = 64 * 66 * 128
    rx_bound = max((samples * 8 + 64 * 12 + 128 * 8 + 64 * 66 * 12)
                   / 3.35e12,
                   64 * 66 * 128 * (23 + 35) / 6.7e13) * 1e3
    assert reader(_cell(), "rx_roofline")(run) == pytest.approx(
        100 * rx_bound / 0.025)
    tx_bound = (samples * 8 + 64 * 66 * 4) / 3.35e12 * 1e3
    assert reader(_cell(), "tx_roofline")(run) == pytest.approx(
        100 * tx_bound / 0.025)


def test_candidates_per_packet():
    assert reader(_cell(), "candidates_per_pkt")(
        SimpleNamespace(outputs=[{"start": _T(range(6))},
                                 {"start": _T(range(4))}],
                        planted=4)) == 1.25


class _T(list):
    def numel(self):
        return len(self)


def test_silent_without_a_trace():
    run = SimpleNamespace(trace=None, host_ms=[], shapes=SHAPES_BATCH,
                          port_kernels=PORT, outputs=[], planted=0)
    for name in ("device_idle_share", "launches_per_call",
                 "host_ms_per_call", "torch_kernels_ms", "rx_roofline",
                 "tx_roofline", "scan_roofline", "candidates_per_pkt"):
        assert reader(_cell(), name)(run) is None, name


def test_breakdown_names_gaps_by_host_op():
    tr = trace.Trace(DEVICE, HOST, 2, (0.0, 1000.0))
    out = trace.breakdown(tr, tr)
    assert out["device_ops"][0][1] == pytest.approx(100e-6)
    gaps = dict(out["idle_gaps"])
    # gaps 100-150 (in topk), 250-600 (midpoint 425: topk and the
    # synchronize have ended) and 700-1000 (in index_select)
    assert gaps == pytest.approx({"aten::index_select": 300e-6,
                                  "host between operations": 350e-6,
                                  "aten::topk": 50e-6})


def test_port_kernel_names_from_sources():
    names = _roofline.port_kernels(ROOT / "lora_sdr_lightweight_standalone_library_clean_tpu_torch")
    assert {"rx_dense_kernel", "rx_hybrid_kernel", "tx_dense_kernel",
            "tx_factored_kernel"} <= names

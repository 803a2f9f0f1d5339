"""The stage readers (``metrics/_stages.py`` and the six metrics that read
it) on a fabricated window, the harness's traced run on the CPU, and the
accepted readers unmoved by the program's spans."""
from __future__ import annotations

from types import SimpleNamespace

import pytest
import torch

from portbench import run as bench_run
from portbench import spec, trace
from portbench.metrics import _stages
from portbench.spec import ROOT, Cell, reader

STAGE_METRICS = ("extract_ms", "select_ms", "estimate_ms", "codec_ms",
                 "program_idle_ms", "syncs_per_call")

# one call over 0 .. 1000 us on the host: the root 0-900 holds extract
# 100-300, demod 300-700 (norm 300-400, estimate 400-600) and a codec
# decode 700-880 with a nested codec span 750-800; a sync at 820-860
SPANS = [("lora.receive_stream", 0, 900), ("lora.rx.extract", 100, 300),
         ("lora.rx.demod", 300, 700), ("lora.rx.norm", 300, 400),
         ("lora.rx.estimate", 400, 600), ("lora.codec.decode", 700, 880),
         ("lora.codec.decode_frame", 750, 800)]
# launches (runtime calls, correlation ids) and what they launched
RUNTIME = [("cudaLaunchKernel", 110, 115, 1),   # in extract
           ("cudaLaunchKernel", 310, 315, 2),   # in norm
           ("cudaLaunchKernel", 450, 455, 3),   # in estimate
           ("cudaLaunchKernel", 650, 655, 4),   # in demod itself
           ("cudaLaunchKernel", 760, 765, 5),   # in the nested codec span
           ("cudaStreamSynchronize", 820, 860, 0),   # in decode
           ("cudaLaunchKernel", 950, 955, 6),   # outside every span
           ("cudaDeviceSynchronize", 960, 990, 0)]   # outside
DEVICE = [("gather", 120, 220, 1), ("norm", 320, 340, 2),
          ("gemm", 460, 520, 3), ("rx", 660, 760, 4),
          ("crc", 770, 800, 5), ("stray", 960, 970, 6)]
# device-side copies of two spans, as record_function makes them
MARKS = [("lora.rx.extract", 120, 220), ("lora.codec.decode", 770, 800)]


def _window(**kw):
    base = dict(spans=SPANS, runtime=RUNTIME, device=DEVICE, calls=1,
                window=(0.0, 1000.0), host_ms=[0.9])
    base.update(kw)
    return _stages.Window(**base)


def _cell():
    return Cell("x", 1, {}, {}, {}, [], [], ROOT)


def _read(window) -> dict:
    run = SimpleNamespace(lora_stages=_stages.analyse(window))
    return {m: reader(_cell(), m)(run) for m in STAGE_METRICS}


def test_stage_arithmetic():
    got = _read(_window())
    assert got["extract_ms"] == pytest.approx(0.100)
    assert got["select_ms"] is None            # no such span opened
    # norm 20 us + estimate 60 us; the kernel launched in demod itself
    # belongs to neither
    assert got["estimate_ms"] == pytest.approx(0.080)
    # the crc, launched in the codec span nested in another, counted once
    assert got["codec_ms"] == pytest.approx(0.030)
    # busy 120-220, 320-340, 460-520, 660-760, 770-800, 960-970 in
    # 0-1000: idle while a span is open (0-900) is 900 - 310 = 590 us
    assert got["program_idle_ms"] == pytest.approx(0.590)
    # the stream sync in the codec span; the harness's outside
    assert got["syncs_per_call"] == 1.0


def test_stage_table_names_every_span_and_wait():
    st = _stages.analyse(_window())
    assert st.syncs == {"lora.codec.decode": 1.0}
    assert st.self_device_ms["lora.rx.demod"] == pytest.approx(0.100)
    assert st.self_device_ms[_stages.NO_SPAN] == pytest.approx(0.010)
    assert st.busy_ms == pytest.approx(0.320)
    # the root's own host time: 900 less its children's 200 + 400 + 180
    assert st.host_self_ms["lora.receive_stream"] == pytest.approx(0.120)
    assert st.untiled == {"lora.receive_stream": pytest.approx(
        100 * 120 / 900)}
    assert st.idle_ms[_stages.NO_SPAN] == pytest.approx(0.090)
    assert [n for n, _ in st.order][:3] == ["lora.receive_stream",
                                           "lora.rx.extract",
                                           "lora.rx.demod"]
    text = _stages.table(st, _window())
    assert "lora.codec.decode 1" in text and "0.010 ms a call" in text


def test_a_root_of_launch_paths_alone_is_one_stage():
    """A root whose only children are kernels' launch paths (the TX) is a
    stage itself: no untiled share is reported for it."""
    st = _stages.analyse(_window(spans=[("lora.tx.modulate", 0, 100),
                                        ("lora.kernel.tx_dense", 80, 90)],
                                 runtime=[], device=[]))
    assert st.untiled == {}
    assert st.host_self_ms["lora.tx.modulate"] == pytest.approx(0.090)


def test_a_launch_without_its_record_is_outside():
    got = _read(_window(runtime=RUNTIME[1:]))
    assert got["extract_ms"] == 0.0


def test_silent_without_program_spans():
    assert _stages.analyse(_window(spans=[])) is None
    for m in STAGE_METRICS:
        assert reader(_cell(), m)(SimpleNamespace(lora_stages=None)) is None
    assert "records no lora. span" in _stages.table(None, _window(spans=[]))


class _Event(SimpleNamespace):
    pass


class _FakeProfile:
    """``torch.profiler.profile`` replaced by one that yields the given
    events."""

    events_to_give: list = []

    def __init__(self, *a, **kw):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def events(self):
        return self.events_to_give


def _ev(name, s, e, cuda, annotation=False, corr=0):
    dev = (torch.autograd.DeviceType.CUDA if cuda
           else torch.autograd.DeviceType.CPU)
    return _Event(name=name, time_range=SimpleNamespace(start=s, end=e),
                  device_type=dev, is_user_annotation=annotation, id=corr)


def _traced(monkeypatch, with_spans: bool) -> trace.Trace:
    events = [_ev(trace.SPAN, 0, 1000, False),
              _ev(trace.SPAN, 0, 1000, True, annotation=True)]
    events += [_ev(n, s, e, True, corr=c) for n, s, e, c in
               [("void rx_dense_kernel<128, lora_rx::StreamReader>(x)",
                 0, 100, 1),
                ("void rx_dense_kernel<128, lora_rx::DirectReader>(x)",
                 300, 400, 2),
                ("tx_dense_kernel(int const*)", 400, 450, 3),
                ("void at::native::elementwise_kernel<128, 2>", 600, 700,
                 4)]]
    events += [_ev(n, s, e, False, corr=c) for n, s, e, c in RUNTIME]
    if with_spans:
        events += [_ev(n, s, e, False, annotation=True)
                   for n, s, e in SPANS]
        events += [_ev(n, s, e, True, annotation=True)
                   for n, s, e in MARKS]
    _FakeProfile.events_to_give = events
    monkeypatch.setattr(torch.profiler, "profile", _FakeProfile)
    return trace.record(lambda: None, 2, sync=lambda: None)


def test_accepted_readers_unmoved_by_the_program_spans(monkeypatch):
    """The device-side copies of the program's spans are no device
    activity: every accepted trace reader reads the same with and without
    the spans in the window."""
    shapes = {"n": 128, "ext_samples": 1 << 20, "windows": 1 << 15,
              "packets": 64, "symbols": 66, "samples": 64 * 66 * 128}
    ports = {"rx_dense_kernel", "tx_dense_kernel"}
    values = []
    for with_spans in (False, True):
        run = SimpleNamespace(trace=_traced(monkeypatch, with_spans),
                              host_ms=[1.0], shapes=shapes, planted=4,
                              port_kernels=ports, outputs=[])
        values.append({m: reader(_cell(), m)(run) for m in (
            "device_idle_share", "launches_per_call", "torch_kernels_ms",
            "scan_roofline", "rx_roofline", "tx_roofline",
            "host_ms_per_call")})
    assert values[0] == values[1]
    assert values[0]["launches_per_call"] == 2.0


@pytest.mark.parametrize("cell", ["sf7-gateway-frames",
                                  "sf12-stream-packets",
                                  "sf7-packet-batch"])
def test_traced_run_reports_the_stage_metrics(tiny_root, cell, capfd):
    """A traced CPU run: the readers find the harness's call, record their
    window and report every stage metric the cell lists (no device here,
    so device ms read 0), with the table on standard error."""
    c = spec.load(cell, tiny_root)
    res = bench_run.run_cell(c, 20250101, 0.2, True, "cpu")
    assert res["correct"], res["checks"]
    want = {m["name"] for m in c.per_layer} & set(STAGE_METRICS)
    assert want <= set(res["metrics"]), res["metrics"]
    for m in want - {"program_idle_ms"}:
        assert res["metrics"][m]["value"] == 0.0, m
    assert res["metrics"]["program_idle_ms"]["value"] > 0
    assert "portbench stages:" in capfd.readouterr().err


def test_traced_run_without_program_spans(tiny_root, monkeypatch):
    """A program that records no span (as one older than its spans): the
    stage metrics are left out and nothing raises."""
    from lora_sdr_lightweight_standalone_library_clean_tpu_torch.utils import (
        spans)
    monkeypatch.setattr(spans, "_profiler_enabled", lambda: False)
    c = spec.load("sf7-packet-batch", tiny_root)
    res = bench_run.run_cell(c, 20250101, 0.2, True, "cpu")
    assert res["correct"]
    assert not set(res["metrics"]) & set(STAGE_METRICS)
    assert "host_ms_per_call" in res["metrics"]

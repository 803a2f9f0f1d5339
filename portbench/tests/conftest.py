"""Shared fixtures of the benchmark's CPU tests: a copy of the benchmark
whose traffic mixes are cut to a size the CPU runs in a second."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

# each mix cut to a few packets: the keys that set its size
TINY = {"gateway-frames": {"stream_samples": 5376 * 12, "max_payload_len": 16,
                           "length_min": 4, "length_max": 16, "altered": 3},
        "gateway-sparse": {"stream_samples": 94464 * 8, "max_payload_len": 16,
                           "length_min": 4, "length_max": 16, "altered": 3},
        "stream-packets": {"stream_samples": 278528 * 24, "altered": 3},
        "packet-batch": {"samples_per_call": 270336 * 2, "altered": 3}}
# the share of moved estimates over a few planted packets is coarse: four
# of twelve sf7 frames may move on the CPU (the TF32 control moves all of
# them); no sf12 packet does, and the control moves a few of 24
TINY_LIMITS = {"sf7-gateway-frames": {"est_moved": 34.0},
               "sf7-gateway-sparse": {"est_moved": 34.0},
               "sf12-stream-packets": {"est_moved": 0.0}}


@pytest.fixture
def tiny_root(tmp_path) -> Path:
    """A benchmark root (BENCHMARK.json and portbench/) whose mixes are
    cut to a few packets."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    pb = tmp_path / "portbench"
    for sub in ("configs", "kinds", "metrics", "limits"):
        shutil.copytree(ROOT / "portbench" / sub, pb / sub)
    (pb / "traffic").mkdir()
    for name, over in TINY.items():
        mix = json.loads((ROOT / "portbench" / "traffic"
                          / f"{name}.json").read_text())
        mix.update(over)
        (pb / "traffic" / f"{name}.json").write_text(json.dumps(mix))
    for cell, over in TINY_LIMITS.items():
        path = pb / "limits" / f"{cell}.json"
        path.write_text(json.dumps({**json.loads(path.read_text()), **over}))
    return tmp_path

"""``run.py`` from the command line: no result and a nonzero exit
without a card, and on a card (marked ``cuda``) one cell end to end."""
from __future__ import annotations

import json
import shutil
import subprocess
import sys

import pytest
import torch

from conftest import ROOT

CMD = [sys.executable, "portbench/run.py", "--workload", "sf7-packet-batch",
       "--seed", str(2 ** 31 + 17), "--seconds", "1", "--trace", "0"]


def _run(cwd, env=None):
    return subprocess.run(CMD, cwd=cwd, capture_output=True, text=True,
                          timeout=600, env=env)


def test_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    out = _run(ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_fails_with_only_the_benchmark(tmp_path):
    """A checkout that holds BENCHMARK.json and portbench/ alone has no
    program to run: no result, nonzero."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    out = _run(tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


@pytest.mark.cuda
def test_one_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = _run(ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert list(res)[-1] == "checks"

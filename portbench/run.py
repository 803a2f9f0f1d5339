"""Run one cell of the benchmark once, on one CUDA card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of ``BENCHMARK.json``; its configuration, traffic
mix, kind of traffic, limits and per-layer readers are files under
``portbench/`` found by name (``spec.py``).  A run:

1. set-up: imports the port, makes the cell's pool of inputs on the
   card from ``--seed`` (``generate.py``, ``kinds/``), and warms up
   every shape the cell calls (the kernel library builds into ``build/``
   of the checkout on the first run there and loads from it after);
2. the window: one closed-loop caller sends calls back to back for
   ``--seconds``, each on the next input of the pool, with at most the
   mix's ``in_flight`` calls sent and not yet finished (1 when the mix
   names none: each call ends before the next is sent); when the time is
   up it sends nothing more, waits for all that was sent, and reads the
   clock after that wait; a reservoir drawn from the seed keeps some
   calls' outputs;
3. with ``--trace 1``, a fixed number of further calls under
   ``torch.profiler`` (``trace.py``);
4. the check: once the peak memory is read, the plain reference
   (``reference/``) runs on each input those calls used, and the kind's
   comparison (``check.py``) judges; each number is printed beside its
   limit on standard error.

The last line of standard output is the result: ``correct``,
``attempted`` and ``failed`` (packets offered in the window, and packets
of the compared calls not delivered as the comparison requires), the
end-to-end metrics (``--trace 0``) or the per-layer ones (``--trace 1``,
with ``breakdown``), ``device``, and ``checks`` last.  It exits nonzero,
printing no result, without a CUDA card (no fallback), or when the
process holds ``jax``, ``jaxlib``, ``flax`` or the JAX package after the
window.
"""
from __future__ import annotations

import time

START = time.perf_counter()

import argparse  # noqa: E402
import collections  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import random  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from portbench import generate, program, spec, trace  # noqa: E402
from portbench.metrics import _roofline  # noqa: E402
from portbench.reference.phy import Phy  # noqa: E402

FORBIDDEN = {"jax", "jaxlib", "flax",
             "lora_sdr_lightweight_standalone_library_clean_tpu"}
KEPT = 6            # calls whose outputs the check compares
TRACED_CALLS = 20   # calls whose device activities the metrics read
NAMED_CALLS = 5     # calls traced with the host's operations (idle gaps)
WARMUP = 2          # calls per pool input before the window

__all__ = ["main", "run_cell", "forbidden_modules"]


def forbidden_modules() -> list:
    """The JAX modules this process holds, by whole top-level name (the
    port's own name begins with the JAX package's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


class _Clock:
    """Per-call time: CUDA events around a call's launches, read on the
    card's timer once the call has finished; the host clock elsewhere."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.free = []      # event pairs whose calls have been read

    def start(self):
        if not self.cuda:
            return [time.perf_counter()]
        mark = self.free.pop() if self.free else [
            torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True)]
        mark[0].record()
        return mark

    def stop(self, mark):
        if self.cuda:
            mark[1].record()
        else:
            mark.append(time.perf_counter())
        return mark

    def read_ms(self, mark) -> float:
        """The call's time, once it has finished (waits for it)."""
        if not self.cuda:
            return (mark[1] - mark[0]) * 1e3
        mark[1].synchronize()
        self.free.append(mark)
        return mark[0].elapsed_time(mark[1])


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize()


def _power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def phy_of(cell) -> Phy:
    cfg = cell.config
    return Phy(sf=cfg["sf"], bw=cfg["bw"], cr=cfg["cr"], osr=cfg["osr"],
               sync_word=cfg["sync_word"])


def judge(cell, phy, pool, kept, prec: str = "f64") -> tuple[dict, int]:
    """Each kept call's outputs against the reference on its input: the
    widest reading of each number over the calls, and the packets those
    calls failed."""
    kind = cell.kind
    worst = {k: 0 for k in kind.NUMBERS}
    failed = 0
    for index in sorted({i for i, _ in kept}):
        inp = pool[index]
        ref = kind.reference(cell.mix, phy, inp, prec)
        for i, got in kept:
            if i != index:
                continue
            nums = kind.compare(kind.outputs(got), ref, inp.truth, cell.mix,
                                phy)
            worst = {k: max(worst[k], nums[k]) for k in worst}
            failed += sum(nums[k] for k in kind.FAILED)
        del ref
    return worst, failed


def run_cell(cell, seed: int, seconds: float, traced: bool, device,
             start: float = START, wrap=None) -> dict:
    """One run of ``cell`` on ``device``; ``wrap(call)`` may replace the
    timed call (the tests' planted faults)."""
    device = torch.device(device)
    mix = cell.mix
    phy = phy_of(cell)
    entry = program.entry(cell, phy)
    pool = [generate.build(cell.kind, mix, phy, seed, i, device)
            for i in range(mix["pool"])]
    call = entry if wrap is None else wrap(entry)
    for inp in pool:
        for _ in range(WARMUP):
            call(inp)
    # as many outputs alive as in the window (the kept ones and the
    # newest), the last on another input than the window's first call
    held = [call(pool[(k - KEPT - 1) % len(pool)]) for k in range(KEPT + 1)]
    _sync(device)
    del held
    clock = _Clock(device)
    rng = random.Random(seed)
    # no collector pass inside the window: what set-up made stays frozen
    gc.collect()
    gc.freeze()
    gc.disable()
    setup_s = time.perf_counter() - start

    in_flight = mix.get("in_flight", 1)
    pending = collections.deque()
    kept, call_ms, host_ms = [], [], []
    w0 = time.perf_counter()
    i = 0
    while True:
        index = i % len(pool)
        t0 = time.perf_counter()
        mark = clock.start()
        out = call(pool[index])
        t1 = time.perf_counter()
        pending.append(clock.stop(mark))
        host_ms.append((t1 - t0) * 1e3)
        if len(pending) >= in_flight:
            call_ms.append(clock.read_ms(pending.popleft()))
        # reservoir: every call is kept with the same chance
        if i < KEPT:
            kept.append((index, out))
        else:
            j = rng.randrange(i + 1)
            if j < KEPT:
                kept[j] = (index, out)
        del out
        i += 1
        if time.perf_counter() - w0 >= seconds:
            break
    while pending:
        call_ms.append(clock.read_ms(pending.popleft()))
    _sync(device)
    w1 = time.perf_counter()
    window_s = w1 - w0
    gc.enable()
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)

    tr = None
    if traced:
        def one():
            return call(pool[0])
        tr = trace.record(one, TRACED_CALLS, lambda: _sync(device),
                          host=device.type != "cuda", in_flight=in_flight)
        named = trace.record(one, NAMED_CALLS, lambda: _sync(device),
                             in_flight=in_flight)
    packets = pool[0].packets
    metrics = {}
    shapes = cell.kind.shapes(mix, phy)
    if traced:
        run = SimpleNamespace(
            trace=tr, host_ms=host_ms, shapes=shapes, planted=packets,
            outputs=[cell.kind.outputs(o) for _, o in kept],
            port_kernels=_roofline.port_kernels(
                cell.root / program.PORT))
        for m in cell.per_layer:
            value = spec.reader(cell, m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = {
            "pkts_per_s": packets * i / window_s,
            "call_p95_ms": statistics.quantiles(call_ms, n=20)[18]
            if len(call_ms) > 1 else call_ms[0],
            "air_s_per_s": shapes["samples"] / phy.sample_rate * i / window_s,
            "setup_s": setup_s,
        }
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers, failed = judge(cell, phy, pool, kept)
    print(f"portbench: {cell.name} seed {seed}: set-up {setup_s:.3f} s, "
          f"{i} calls in {window_s:.3f} s, check "
          f"{time.perf_counter() - t_check:.3f} s", file=sys.stderr)
    checks = {k: {"value": v, "limit": cell.limits[k]}
              for k, v in numbers.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": cell.chips, "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": packets * i,
              "failed": failed, "metrics": metrics, "device": dev}
    if traced:
        busy = sum(e - s for s, e in trace.busy_intervals(tr))
        dev.update(busy_s=busy * 1e-6,
                   window_s=(tr.window[1] - tr.window[0]) * 1e-6)
        result["breakdown"] = trace.breakdown(tr, named)
    result["calls"] = i
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = spec.load(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA "
              f"card(s); found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    # one host thread for the port's CPU work: the caller is the load
    torch.set_num_threads(1)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      "cuda")
    found = forbidden_modules()
    if found:
        print(f"portbench: the process holds {', '.join(found)}",
              file=sys.stderr)
        return 3
    limit_w = _power_limit()
    result["device"]["power_limit_w"] = limit_w
    for name, m in result["metrics"].items():
        if name.endswith("_roofline") or m["unit"] == "%":
            print(f"{name} {m['value']!r} % (card power limit {limit_w} W)",
                  file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())

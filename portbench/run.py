"""Run one cell of the benchmark once, on the CUDA cards it asks for.

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

A cell of one chip runs in this process.  A cell of ``chips`` > 1 runs
one process per rank, each on its own card (``ranks.py``): every rank
makes the same calls in lockstep, and the ranks' readings are merged into
one result (``run_cell``'s ``group``).

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
import torch.distributed as dist  # noqa: E402

from portbench import generate, program, ranks, spec, trace  # noqa: E402
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


class _Lockstep:
    """The window's end across ranks: rank 0's host clock decides, and
    every rank stops after the same call.  After every ``EVERY``-th call
    a rank reads the decision rank 0 posted ``EVERY`` calls before (a
    broadcast on the harness's gloo group, sent without waiting for it)
    and posts rank 0's current one, so no rank waits on the exchange
    inside a call's CUDA-event interval, and the stop lags by at most
    2 x ``EVERY`` calls.  One exchange costs the host 0.25-0.65 ms (gloo
    over loopback, on the four-H100 machine and on an 8-core CPU host),
    hence not one every call."""

    EVERY = 8

    def __init__(self, group):
        self.group = group
        self.flag = torch.zeros(1, dtype=torch.int32)
        self.work = None
        self.seconds = 0.0      # host time spent here, over the window

    def stop(self, calls: int, due: bool) -> bool:
        if calls % self.EVERY:
            return False
        t0 = time.perf_counter()
        done = False
        if self.work is not None:
            self.work.wait()
            done = bool(self.flag[0])
        if not done:
            self.flag[0] = int(due)
            self.work = dist.broadcast(self.flag, 0, group=self.group,
                                       async_op=True)
        self.seconds += time.perf_counter() - t0
        return done


def _every(group, value) -> list:
    """``value`` of every rank, in rank order; ``[value]`` without a
    group."""
    if group is None:
        return [value]
    out = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, value, group=group)
    return out


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
             start: float = START, wrap=None, group=None) -> dict:
    """One run of ``cell`` on ``device``; ``wrap(call)`` may replace the
    timed call (the tests' planted faults).

    ``group``: the harness's own gloo group when the cell runs across
    ranks, each rank calling this with its own card; None for one chip.
    With a group, a barrier ends set-up and another closes the window
    once every rank's card has finished, every rank stops after the same
    call (``_Lockstep``), and the readings merge over the ranks: a call
    takes the slowest rank's time, each compared number its widest
    reading, ``failed`` the largest (a mesh call's outputs are global on
    every rank), and the peak memory the fullest card's.  The per-layer
    metrics and ``breakdown`` are this rank's."""
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
    lockstep = None
    if group is not None:
        dist.barrier(group=group)
        lockstep = _Lockstep(group)
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
        if lockstep is None:
            if time.perf_counter() - w0 >= seconds:
                break
        elif lockstep.stop(i, time.perf_counter() - w0 >= seconds):
            break
    while pending:
        call_ms.append(clock.read_ms(pending.popleft()))
    _sync(device)
    if group is not None:
        dist.barrier(group=group)
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
    busy_s = window_s_traced = None
    if traced:
        run = SimpleNamespace(
            trace=tr, host_ms=host_ms, shapes=shapes, planted=packets,
            outputs=[cell.kind.outputs(o) for _, o in kept],
            port_kernels=_roofline.port_kernels(
                cell.root / program.PORT),
            call=one, device=device, in_flight=in_flight)
        for m in cell.per_layer:
            value = spec.reader(cell, m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        busy_s = sum(e - s for s, e in trace.busy_intervals(tr)) * 1e-6
        window_s_traced = (tr.window[1] - tr.window[0]) * 1e-6
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers, failed = judge(cell, phy, pool, kept)
    rank = "" if group is None else \
        f" (rank {dist.get_rank()} of {dist.get_world_size()})"
    print(f"portbench: {cell.name} seed {seed}{rank}: set-up {setup_s:.3f} "
          f"s, {i} calls in {window_s:.3f} s, check "
          f"{time.perf_counter() - t_check:.3f} s", file=sys.stderr)
    every = _every(group, {
        "calls": i, "call_ms": call_ms, "setup_s": setup_s, "peak": peak,
        "kind": (torch.cuda.get_device_name(device)
                 if device.type == "cuda" else "cpu"),
        "numbers": numbers, "failed": failed, "busy_s": busy_s,
        "window_s": window_s_traced,
        "stop_us": (lockstep.seconds / i * 1e6
                    if lockstep is not None else None)})
    if len({r["calls"] for r in every}) != 1:
        raise RuntimeError("the ranks made different numbers of calls: "
                           f"{[r['calls'] for r in every]}")
    call_ms = [max(ms) for ms in zip(*(r["call_ms"] for r in every))]
    if len(every) > 1 and dist.get_rank() == 0:
        _print_ranks(every)
    if not traced:
        values = {
            "pkts_per_s": packets * i / window_s,
            "call_p95_ms": statistics.quantiles(call_ms, n=20)[18]
            if len(call_ms) > 1 else call_ms[0],
            "air_s_per_s": shapes["samples"] / phy.sample_rate * i / window_s,
            "setup_s": max(r["setup_s"] for r in every),
        }
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    checks = {k: {"value": max(r["numbers"][k] for r in every),
                  "limit": cell.limits[k]} for k in numbers}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": every[0]["kind"], "count": len(every),
           "memory_peak_bytes": max(r["peak"] for r in every)}
    result = {"correct": correct, "attempted": packets * i,
              "failed": max(r["failed"] for r in every), "metrics": metrics,
              "device": dev}
    if traced:
        # averaged over the cards used
        dev.update(busy_s=sum(r["busy_s"] for r in every) / len(every),
                   window_s=sum(r["window_s"] for r in every) / len(every))
        result["breakdown"] = trace.breakdown(tr, named)
    if len(every) > 1:
        dev["per_rank"] = [{"kind": r["kind"], "memory_peak_bytes": r["peak"]}
                           for r in every]
    result["calls"] = i
    result["checks"] = checks
    return result


def _print_ranks(every: list) -> None:
    """A run across ranks, on standard error: each rank's set-up and stop
    exchange, and how far the ranks' times of one call lie apart."""
    skew = sorted(max(ms) - min(ms)
                  for ms in zip(*(r["call_ms"] for r in every)))
    for k, r in enumerate(every):
        print(f"portbench: rank {k} on {r['kind']}: set-up {r['setup_s']:.3f}"
              f" s, stop exchange {r['stop_us']:.1f} us a call, peak "
              f"{r['peak']} B", file=sys.stderr)
    print(f"portbench: ranks' times of one call apart by {skew[-1]:.4f} ms "
          f"at most, {statistics.median(skew):.4f} ms in the median",
          file=sys.stderr)


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
    if cell.chips == 1:
        result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                          "cuda")
    else:
        result = ranks.launch(cell, args.seed, args.seconds,
                              bool(args.trace), start=START)
        if result is None:
            return 4
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

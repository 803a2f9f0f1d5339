"""The program's stages, read out of one ``torch.profiler`` window of its
own: device ms, host ms, device-idle ms and host waits by stage.

The port marks its stages with spans named ``lora.*`` on the profiler's
timeline (an entry point's span is the root, its stages nest inside it),
the clock that the device activities share.  A device activity belongs to
the spans open on the host when it was launched: its correlation id names
the CUDA runtime call that launched it, and that call's start time the
innermost span open then.  So a stage's device ms is the time of the
activities launched inside its span, nested spans included, counted once
whatever the stream or the order in which the card ran them.

The window: ``CALLS`` further calls of the cell's traced call (the one the
other traced windows take), with the host's operations and the device's
activities, each call inside the benchmark's span (``trace.SPAN``) and
synchronised as the harness's own windows are.  The run's record that the
harness hands its readers holds the call, its device and the calls in
flight (``run.call``, ``run.device``, ``run.in_flight``); the first
reader records and analyses the window, keeps the result on ``run`` for
the other readers, and prints its table to standard error once.  Without
``lora.`` spans in the window (a program that records none) every stage
reader returns None.
"""
from __future__ import annotations

import bisect
import sys
import time
from typing import NamedTuple

__all__ = ["CALLS", "SYNCS", "Window", "Stages", "record", "analyse",
           "of", "device_ms", "table"]

CALLS = 5
PREFIX = "lora."
KERNEL = "lora.kernel."
# host calls that wait for the device
SYNCS = frozenset({"cudaStreamSynchronize", "cudaDeviceSynchronize",
                   "cudaEventSynchronize", "cudaMemcpy", "cudaMemcpy2D",
                   "cuStreamSynchronize", "cuCtxSynchronize",
                   "cuEventSynchronize"})
NO_SPAN = "(no lora. span)"


class Window(NamedTuple):
    spans: list     # (name, start us, end us) of the program's spans
    runtime: list   # (name, start us, end us, correlation id) of the
    #                 host's calls into the CUDA runtime or driver
    device: list    # (name, start us, end us, correlation id) of the
    #                 device's activities
    calls: int
    window: tuple   # (start us, end us)
    host_ms: list   # each call's host ms, to its return


class Stages(NamedTuple):
    calls: int
    busy_ms: float          # the union of device activities, a call
    acts: list              # (device us, frozenset of its spans' names)
    order: list             # (name, depth) by first appearance
    count: dict             # spans a call, by name
    host_self_ms: dict      # a call, by name: its time less its children's
    self_device_ms: dict    # a call, by innermost span
    idle_ms: dict           # device-idle ms a call, by innermost span
    syncs: dict             # host waits a call, by innermost span
    untiled: dict           # root name: largest share of a root's host
    #                         time in no stage span (roots with stages)
    unmatched: int          # device activities with no launch record


def record(call, calls: int = CALLS, sync=None, in_flight: int = 1,
           cuda: bool = True) -> Window:
    """``calls`` calls of ``call()`` under the profiler, host and device,
    each in the benchmark's span, with ``sync()`` after every
    ``in_flight``-th call and the last."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from portbench.trace import SPAN
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                     else [])
    sync = sync or (lambda: None)
    host_ms = []
    with profile(activities=acts) as prof:
        sync()
        for k in range(calls):
            with torch.profiler.record_function(SPAN):
                t0 = time.perf_counter()
                call()
                host_ms.append((time.perf_counter() - t0) * 1e3)
                if (k + 1) % in_flight == 0 or k + 1 == calls:
                    sync()
    spans, runtime, device, bench = [], [], [], []
    for e in prof.events():
        s, t = float(e.time_range.start), float(e.time_range.end)
        if e.device_type == torch.autograd.DeviceType.CUDA:
            # the device-side copy of a host span is no device activity
            if not (e.name == SPAN or e.name.startswith(PREFIX)
                    or getattr(e, "is_user_annotation", False)):
                device.append((e.name, s, t, e.id))
        elif e.name.startswith(PREFIX):
            spans.append((e.name, s, t))
        elif e.name == SPAN:
            bench.append((s, t))
        elif e.name.startswith("cu"):
            runtime.append((e.name, s, t, e.id))
    window = ((min(s for s, _ in bench), max(t for _, t in bench))
              if bench else (0.0, 0.0))
    return Window(spans, runtime, device, calls, window, host_ms)


def _union(intervals) -> list:
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [tuple(m) for m in merged]


def _overlap(s: float, e: float, intervals: list) -> float:
    """The overlap of [s, e) with sorted disjoint ``intervals``."""
    k = max(bisect.bisect_right(intervals, (s,)) - 1, 0)
    total = 0.0
    while k < len(intervals) and intervals[k][0] < e:
        total += max(0.0, min(e, intervals[k][1]) - max(s, intervals[k][0]))
        k += 1
    return total


def _tree(spans: list):
    """The spans in start order (an outer span before the spans it holds)
    and each one's parent index (-1 for a root): spans nest, so the open
    ones form a stack."""
    nodes = sorted(spans, key=lambda s: (s[1], -s[2]))
    parent, stack = [], []
    for i, (_, s, e) in enumerate(nodes):
        while stack and nodes[stack[-1]][2] <= s:
            stack.pop()
        parent.append(stack[-1] if stack else -1)
        stack.append(i)
    return nodes, parent


def _segments(nodes: list, lo: float, hi: float) -> list:
    """[lo, hi) cut where the innermost open span changes: (start, end,
    index of the innermost span or -1)."""
    marks = sorted([(s, 1, i) for i, (_, s, _e) in enumerate(nodes)]
                   + [(e, 0, i) for i, (_, _s, e) in enumerate(nodes)])
    out, stack, at = [], [], lo
    for t, start, i in marks:
        t = min(max(t, lo), hi)
        if t > at:
            out.append((at, t, stack[-1] if stack else -1))
            at = t
        if start:
            stack.append(i)
        elif i in stack:
            stack.remove(i)
    if hi > at:
        out.append((at, hi, stack[-1] if stack else -1))
    return out


def _innermost(segments: list, t: float) -> int:
    """The innermost span open at ``t`` (-1 for none)."""
    k = bisect.bisect_right(segments, (t, float("inf"), 0)) - 1
    if k < 0 or not segments[k][0] <= t < segments[k][1]:
        return -1
    return segments[k][2]


def analyse(w: Window) -> Stages | None:
    """The window's stages; None when it holds no program span."""
    if not w.spans:
        return None
    calls = w.calls
    nodes, parent = _tree(w.spans)
    lo, hi = w.window
    lo = min([lo] + [s for _, s, _ in nodes])
    hi = max([hi] + [e for _, _, e in nodes])
    segs = _segments(nodes, lo, hi)

    def chain(i):
        names = []
        while i >= 0:
            names.append(nodes[i][0])
            i = parent[i]
        return frozenset(names)

    launched = {c: s for _, s, _, c in w.runtime}
    acts, self_dev, unmatched = [], {}, 0
    for _, s, e, corr in w.device:
        at = launched.get(corr)
        if at is None:
            unmatched += 1
            i = -1
        else:
            i = _innermost(segs, at)
        acts.append((e - s, chain(i)))
        key = nodes[i][0] if i >= 0 else NO_SPAN
        self_dev[key] = self_dev.get(key, 0.0) + (e - s)

    busy = [(max(s, lo), min(e, hi))
            for s, e in _union((s, e) for _, s, e, _ in w.device)
            if e > lo and s < hi]
    gaps, at = [], lo
    for s, e in busy:
        if s > at:
            gaps.append((at, s))
        at = max(at, e)
    if hi > at:
        gaps.append((at, hi))
    idle = {}
    for s, e, i in segs:
        free = _overlap(s, e, gaps)
        if free > 0:
            key = nodes[i][0] if i >= 0 else NO_SPAN
            idle[key] = idle.get(key, 0.0) + free

    syncs = {}
    for name, s, _, _ in w.runtime:
        if name in SYNCS:
            i = _innermost(segs, s)
            if i >= 0:
                syncs[nodes[i][0]] = syncs.get(nodes[i][0], 0) + 1

    count, host_self, order, seen = {}, {}, [], set()
    child_us = [0.0] * len(nodes)
    for i, (_, s, e) in enumerate(nodes):
        if parent[i] >= 0:
            child_us[parent[i]] += e - s
    # a stage is a child span other than a kernel's launch path: a root
    # whose children are launch paths alone (lora.tx.modulate) is one stage
    staged = {parent[i] for i, (name, _, _) in enumerate(nodes)
              if parent[i] >= 0 and not name.startswith(KERNEL)}
    untiled = {}
    for i, (name, s, e) in enumerate(nodes):
        count[name] = count.get(name, 0) + 1
        host_self[name] = host_self.get(name, 0.0) + (e - s - child_us[i])
        if name not in seen:
            depth, j = 0, parent[i]
            while j >= 0:
                depth, j = depth + 1, parent[j]
            order.append((name, depth))
            seen.add(name)
        if parent[i] < 0 and i in staged:
            share = 100.0 * (e - s - child_us[i]) / (e - s)
            untiled[name] = max(untiled.get(name, 0.0), share)

    def per_call_ms(d):
        return {k: v / 1e3 / calls for k, v in d.items()}
    return Stages(
        calls=calls,
        busy_ms=sum(e - s for s, e in busy) / 1e3 / calls,
        acts=acts,
        order=order,
        count={k: v / calls for k, v in count.items()},
        host_self_ms=per_call_ms(host_self),
        self_device_ms=per_call_ms(self_dev),
        idle_ms=per_call_ms(idle),
        syncs={k: v / calls for k, v in syncs.items()},
        untiled=untiled,
        unmatched=unmatched,
    )


def device_ms(st: Stages | None, match) -> float | None:
    """Device ms a call of the activities launched inside any span whose
    name ``match`` accepts, each counted once; None when no such span
    opened."""
    if st is None or not any(match(name) for name, _ in st.order):
        return None
    us = sum(d for d, names in st.acts if any(match(n) for n in names))
    return us / 1e3 / st.calls


def table(st: Stages | None, w: Window) -> str:
    """The per-stage table of a window, as printed to standard error."""
    host = sum(w.host_ms) / max(len(w.host_ms), 1)
    head = (f"portbench stages: {w.calls} calls, host {host:.3f} ms a call "
            f"to its return (profiler on)")
    if st is None:
        return head + "; the program records no lora. span"
    lines = [head + f", busy device {st.busy_ms:.3f} ms a call",
             f"  {'span':<36}{'n/call':>7}{'host self ms':>14}"
             f"{'device ms':>11}{'incl.':>10}{'idle ms':>9}"]
    for name, depth in st.order + [(NO_SPAN, 0)]:
        incl = device_ms(st, lambda n, x=name: n == x)
        lines.append(
            f"  {'  ' * depth + name:<36}{st.count.get(name, 0):>7.1f}"
            f"{st.host_self_ms.get(name, 0.0):>14.3f}"
            f"{st.self_device_ms.get(name, 0.0):>11.3f}"
            f"{(incl if incl is not None else 0.0):>10.3f}"
            f"{st.idle_ms.get(name, 0.0):>9.3f}")
    outside = st.self_device_ms.get(NO_SPAN, 0.0)
    share = 100.0 * outside / st.busy_ms if st.busy_ms else 0.0
    lines.append(f"  launched outside any lora. span: {outside:.3f} ms a "
                 f"call ({share:.2f} % of busy); activities with no launch "
                 f"record: {st.unmatched}")
    for name, share in st.untiled.items():
        lines.append(f"  {name}: {share:.2f} % of its host time in no stage "
                     f"span (the largest over its calls)")
    waits = ", ".join(f"{k} {v:g}" for k, v in sorted(st.syncs.items()))
    lines.append(f"  host waits on the device a call, by innermost span: "
                 f"{sum(st.syncs.values()):g}" + (f" ({waits})" if waits
                                                   else ""))
    return "\n".join(lines)


def of(run) -> Stages | None:
    """The stages of the run's cell: recorded and analysed at the first
    reader's call, then kept on ``run``."""
    if hasattr(run, "lora_stages"):
        return run.lora_stages
    run.lora_stages = None
    if getattr(run, "call", None) is None \
            or getattr(run, "trace", None) is None:
        return None
    cuda = run.device.type == "cuda"
    if cuda:
        import torch
        sync = torch.cuda.synchronize
    else:
        sync = None
    w = record(run.call, CALLS, sync, run.in_flight, cuda)
    run.lora_stages = analyse(w)
    print(table(run.lora_stages, w), file=sys.stderr)
    return run.lora_stages

"""Traced windows: a fixed number of calls under ``torch.profiler``.

The metrics' window records the device activities (kernels, copies,
fills) alone; a shorter one records the host operations too, on the
profiler's one timeline with the device's, and the benchmark's own span
around each call (``portbench.call``, from the call's start to its
return, or to the synchronize after it where one follows), so that each
idle gap can be named by what the host was doing in it.  Nothing is written to disk.
"""
from __future__ import annotations

import time
from typing import NamedTuple

import torch

__all__ = ["Trace", "record", "busy_intervals", "breakdown", "SPAN"]

SPAN = "portbench.call"


class Trace(NamedTuple):
    device: list        # (name, start us, end us) of each device activity
    host: list          # (name, start us, end us) of each host operation
    calls: int          # calls traced
    window: tuple       # (start us, end us)


def record(call, calls: int, sync=torch.cuda.synchronize,
           host: bool = True, in_flight: int = 1) -> Trace:
    """Run ``call()`` ``calls`` times under the profiler, each inside the
    benchmark's span, with ``sync()`` after every ``in_flight``-th call
    and the last, as the window sends them.  ``host=False`` records
    the device's activities alone, which costs the host far less; the
    window is then the host clock's reading of the calls, from the first
    device activity on."""
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
    with profile(activities=acts) as prof:
        sync()
        t0 = time.perf_counter()
        for k in range(calls):
            with record_function(SPAN):
                call()
                if (k + 1) % in_flight == 0 or k + 1 == calls:
                    sync()
        seconds = time.perf_counter() - t0
    device, ops, spans = [], [], []
    for e in prof.events():
        item = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.device_type == torch.autograd.DeviceType.CUDA:
            # the device-side copy of a host span is no device activity
            if not (e.name == SPAN or getattr(e, "is_user_annotation",
                                               False)):
                device.append(item)
        elif e.name == SPAN:
            spans.append(item)
        else:
            ops.append(item)
    if spans:
        window = (min(s for _, s, _ in spans), max(e for _, _, e in spans))
    else:
        first = min((s for _, s, _ in device), default=0.0)
        window = (first, first + seconds * 1e6)
    return Trace(device, ops, calls, window)


def busy_intervals(trace: Trace) -> list:
    """The union of the device activities inside the window, as disjoint
    (start, end) intervals in us."""
    lo, hi = trace.window
    spans = sorted((max(s, lo), min(e, hi)) for _, s, e in trace.device
                   if e > lo and s < hi)
    merged = []
    for s, e in spans:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [tuple(m) for m in merged]


def _gaps(trace: Trace) -> list:
    lo, hi = trace.window
    gaps, at = [], lo
    for s, e in busy_intervals(trace):
        if s > at:
            gaps.append((at, s))
        at = max(at, e)
    if hi > at:
        gaps.append((at, hi))
    return gaps


def _host_at(trace: Trace, times: list) -> list:
    """For each of the ascending ``times``, the innermost host operation
    open then (host operations nest, so the open ones form a stack)."""
    ops = sorted((s, e, name) for name, s, e in trace.host)
    out, stack, i = [], [], 0
    for t in times:
        while i < len(ops) and ops[i][0] <= t:
            while stack and stack[-1][1] <= ops[i][0]:
                stack.pop()
            stack.append(ops[i])
            i += 1
        while stack and stack[-1][1] <= t:
            stack.pop()
        out.append(stack[-1][2] if stack else "host between operations")
    return out


def breakdown(device: Trace, host: Trace, top: int = 10) -> dict:
    """The device operations that took most time (over the calls of
    ``device``) and the idle gaps by what the host was doing in them (over
    the calls of ``host``, which records the host's operations), seconds
    summed: {"device_ops": [[name, s], ...], "idle_gaps": [[name, s],
    ...]}."""
    ops, idle = {}, {}
    for name, s, e in device.device:
        ops[name] = ops.get(name, 0.0) + (e - s) * 1e-6
    gaps = _gaps(host)
    for (s, e), name in zip(gaps, _host_at(host, [(s + e) / 2.0
                                                  for s, e in gaps])):
        idle[name] = idle.get(name, 0.0) + (e - s) * 1e-6

    def first(d):
        return [[k[:200], v] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"device_ops": first(ops), "idle_gaps": first(idle)}

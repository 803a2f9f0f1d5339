"""Share of the traced window in which no device activity ran, in %: one
minus the union of the device activities over the window, both from one
``torch.profiler`` window of a fixed number of calls."""
from portbench.trace import busy_intervals


def read(run):
    t = run.trace
    if t is None or not t.device:
        return None
    lo, hi = t.window
    busy = sum(e - s for s, e in busy_intervals(t))
    return 100.0 * (1.0 - busy / (hi - lo))

"""Device activities (kernels, copies, fills) per call, from the trace:
what the host dispatch layer enqueues for one call."""


def read(run):
    t = run.trace
    if t is None or not t.device:
        return None
    return len(t.device) / t.calls

"""Device ms per call of everything that is not one of the program's own
CUDA kernels: PyTorch's and cuBLAS's kernels, copies and fills.  A kernel
a later change adds to the program's ``csrc/`` leaves this sum by its
name."""


def read(run):
    t = run.trace
    if t is None or not t.device:
        return None
    us = sum(e - s for name, s, e in t.device
             if not any(k in name for k in run.port_kernels))
    return us / 1e3 / t.calls

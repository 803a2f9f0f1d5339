"""Device ms a call launched inside the program's ``lora.rx.collective.*``
spans (halo, scan and results) on the rank whose trace the run reads, from
``_stages``' window: the NCCL kernels, whose time includes their wait for
the other ranks, so the sum reads their skew.  None for a program that
opens no collective span."""
from portbench.metrics import _stages


def read(run):
    return _stages.device_ms(_stages.of(run),
                             lambda name: name.startswith(
                                 "lora.rx.collective."))

"""Device ms a call of the streaming receiver's start selection: the
device activities launched inside the program's ``lora.rx.select`` spans
(the packet-start search over the scan's windows, the ownership mask, the
first ``max_packets`` and their clamp), from the stage window of
``_stages``."""
from portbench.metrics import _stages


def read(run):
    return _stages.device_ms(_stages.of(run),
                             lambda name: name == "lora.rx.select")

"""Device ms a call of the codec: the device activities launched inside
the program's ``lora.codec.*`` spans (raw and framed encode and decode,
the CRCs), each counted once where codec spans nest, from the stage
window of ``_stages``."""
from portbench.metrics import _stages


def read(run):
    return _stages.device_ms(_stages.of(run),
                             lambda name: name.startswith("lora.codec."))

"""Device ms a call of the streaming receiver's extraction: the device
activities launched inside the program's ``lora.rx.extract`` spans (the
gather of each provisioned packet's row from [tail | chunk] and its
dechirp), from the stage window of ``_stages``."""
from portbench.metrics import _stages


def read(run):
    return _stages.device_ms(_stages.of(run),
                             lambda name: name == "lora.rx.extract")

"""Device ms a call of the demodulator's normalization and estimator: the
device activities launched inside the program's ``lora.rx.norm`` (the two
inf-norms and the scale) and ``lora.rx.estimate`` spans (the CFO/timing
estimator's DFTs and reductions), from the stage window of
``_stages``."""
from portbench.metrics import _stages

NAMES = ("lora.rx.norm", "lora.rx.estimate")


def read(run):
    return _stages.device_ms(_stages.of(run), lambda name: name in NAMES)

"""Host waits on the device a call inside the program's ``lora.`` spans
(``cudaStreamSynchronize``, ``cudaDeviceSynchronize``,
``cudaEventSynchronize``, a blocking ``cudaMemcpy``: ``_stages.SYNCS``),
from the stage window of ``_stages``, whose table on standard error names
the span each one was made in."""
from portbench.metrics import _stages


def read(run):
    st = _stages.of(run)
    if st is None:
        return None
    return float(sum(st.syncs.values()))

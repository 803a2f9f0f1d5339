"""Device-idle ms a call while one of the program's ``lora.`` spans is
open on the host: the card waiting on the program (its Python, launch
paths, table lookups and host waits), not on the harness, from the stage
window of ``_stages`` (the gaps in the union of device activities, cut
where the host's innermost span changes)."""
from portbench.metrics import _stages


def read(run):
    st = _stages.of(run)
    if st is None:
        return None
    return sum(ms for name, ms in st.idle_ms.items()
               if name != _stages.NO_SPAN)

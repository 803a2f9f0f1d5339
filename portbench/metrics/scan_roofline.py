"""The stream scan's share of its roofline, %: the least time the card
could take to scan the call's [tail | chunk] (``_roofline.scan_work``)
over the scan kernel's device time per call (the program's kernels that
read through ``StreamReader``)."""
from portbench.metrics import _roofline


def read(run):
    return _roofline.share(run, _roofline.scan_work,
                           lambda name: "StreamReader" in name)

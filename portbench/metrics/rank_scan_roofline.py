"""The stream scan's share of its roofline on one rank of a stream split
over ``sp`` ranks, %: the least time the card could take to scan the
windows that start in rank 0's block of [tail | chunk] (its ``1/sp`` of
the call's samples plus the carried tail, ``row_samples``; counted by
``_roofline.scan_work``), over the scan kernel's device time a call in
rank 0's trace.  None for a cell whose shapes name no ``sp``."""
from portbench.metrics import _roofline


def read(run):
    shapes = run.shapes
    if "sp" not in shapes:
        return None
    ext = shapes["row_samples"] + shapes["samples"] // shapes["sp"]
    rank = {"n": shapes["n"], "ext_samples": ext,
            "windows": ext // shapes["stride"]}
    return _roofline.share(run, lambda _: _roofline.scan_work(rank),
                           lambda name: "StreamReader" in name)

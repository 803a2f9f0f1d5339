"""The TX kernels' share of their roofline, %: the least time to write
the call's samples and read its symbols (``_roofline.tx_work``, the same
whatever form the kernel takes) over the device time of the program's
``tx_*`` kernels."""
from portbench.metrics import _roofline


def read(run):
    return _roofline.share(run, _roofline.tx_work,
                           lambda name: "tx_" in name)

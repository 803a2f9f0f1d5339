"""The packet RX kernel's share of its roofline, %: the least time for
the call's packets x windows x n (``_roofline.rx_work``) over the device
time of the program's ``rx_*_kernel`` instances that read packet windows
(``DirectReader``)."""
from portbench.metrics import _roofline


def read(run):
    return _roofline.share(run, _roofline.rx_work,
                           lambda name: "rx_" in name
                           and "DirectReader" in name)

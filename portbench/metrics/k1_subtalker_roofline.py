"""Kernel 1 (`k_subtalker_frame`, the fused sub-talker frame): the least
time of its launches in the traced window (`roofline.subtalker_launch` at
each launch's rows: the server's slots, as row tiles of at most 32) over
their device time."""

from portbench import roofline
from portbench.kernels import kernel_time, rows_per_launch


def read(run):
    n, s = kernel_time(run, "k_subtalker_frame")
    if not n or s <= 0:
        return None
    return 100.0 * n * roofline.subtalker_launch(run.config, rows_per_launch(run.slots)) / s

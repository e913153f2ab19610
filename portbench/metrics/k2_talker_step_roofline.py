"""Kernel 2 (`k_talker_step`, the fused talker decode step): the least time
of its launches in the traced window (`roofline.talker_step_launch`: the
int8 weights once a launch, each row's valid KV slots, from the frames the
window generated) over their device time."""

from portbench import roofline
from portbench.kernels import kernel_time, rows_per_launch


def read(run):
    n, s = kernel_time(run, "k_talker_step")
    if not n or s <= 0:
        return None
    kv_per_launch = sum(run.frames) / n
    return 100.0 * n * roofline.talker_step_launch(run.config, rows_per_launch(run.slots),
                                                   kv_per_launch) / s

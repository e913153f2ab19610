"""The share of the traced window in which no operation ran on the card
(the union of the profiler's device spans)."""


def read(run):
    if run.busy_s is None:
        return None
    return 100.0 * (1.0 - run.busy_s / run.window_s)

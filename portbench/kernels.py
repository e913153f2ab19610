"""Helpers shared by the per-layer readers of the hand-written kernels."""

# one launch of the port's layer engine takes at most this many rows; the
# wrappers run larger batches as equal row tiles
ENGINE_MAX_ROWS = 32


def kernel_time(run, name: str):
    """(launches, device seconds) of the kernels whose name holds `name` in
    the traced window."""
    n, s = 0, 0.0
    for full, (count, secs) in run.kernels.items():
        if name in full:
            n += count
            s += secs
    return n, s


def rows_per_launch(slots: int) -> float:
    tiles = -(-slots // ENGINE_MAX_ROWS)
    return slots / tiles

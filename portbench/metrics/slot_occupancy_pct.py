"""The engine's frames over its slot-ticks in the window (the port's
counters `engine.frames` and `engine.ticks`, deltas over the window)."""


def read(run):
    ticks = run.counters.get("engine.ticks", 0.0)
    if not ticks:
        return None
    return 100.0 * run.counters.get("engine.frames", 0.0) / (ticks * run.slots)

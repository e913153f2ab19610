"""The card's time per serve tick: the device milliseconds of the
`engine.chunk` span (CUDA events around each chunk's one-tick graph
replays) over the ticks the engine launched (`engine.ticks`), both
counter deltas over the traced window. A chunk's events resolve a step or
two after it runs, so the window counts the ticks of its last chunks
without their milliseconds and the milliseconds of the chunks before it
that resolved inside it."""


def read(run):
    ms = run.counters.get("engine.chunk.device_ms")
    ticks = run.counters.get("engine.ticks")
    if not ms or not ticks:
        return None
    return ms / ticks

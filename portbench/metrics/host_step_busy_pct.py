"""The share of the traced window the serving loop's host thread spends
working inside the program: the host milliseconds of the `server.step`
and `server.submit` spans less those of their three waits on the card
(`server.fast_first_wait`, `engine.aux_wait`, `server.egress_wait`),
counter deltas, over the window."""

WAITS = ("server.fast_first_wait", "engine.aux_wait", "server.egress_wait")


def read(run):
    c = run.counters
    step = c.get("server.step.host_ms")
    if not step:
        return None
    busy = step + c.get("server.submit.host_ms", 0.0) - sum(
        c.get(f"{w}.host_ms", 0.0) for w in WAITS)
    return 100.0 * busy / (run.window_s * 1e3)

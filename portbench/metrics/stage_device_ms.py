"""The card's time per staged request: the device milliseconds of the
`engine.stage` span (CUDA events around each staging prefill's graph
replay) over the requests staged (`engine.staged_rows`, padding rows not
counted), counter deltas over the traced window."""


def read(run):
    ms = run.counters.get("engine.stage.device_ms")
    rows = run.counters.get("engine.staged_rows")
    if not ms or not rows:
        return None
    return ms / rows

"""The 95th percentile (nearest rank) over the window's requests of
admission (submit to staged: the request waits for a staging prefill), from the engine's per-request host timestamps (traced runs)."""

from portbench.harness import percentile


def read(run):
    spans = [(r.trace["staged"] - r.trace["submit"]) * 1e3 for r in run.requests
             if r.trace and "submit" in r.trace and "staged" in r.trace]
    return percentile(spans, 95)

"""The 95th percentile (nearest rank) over the window's requests of
the staging prefill and the frame loop up to the request's first frame on the host (staged to first_frame), from the engine's per-request host timestamps (traced runs)."""

from portbench.harness import percentile


def read(run):
    spans = [(r.trace["first_frame"] - r.trace["staged"]) * 1e3 for r in run.requests
             if r.trace and "staged" in r.trace and "first_frame" in r.trace]
    return percentile(spans, 95)

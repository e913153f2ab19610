"""The 95th percentile (nearest rank) over the window's requests of
the server's egress (first frame on the host to first packet), from the engine's per-request host timestamps (traced runs)."""

from portbench.harness import percentile


def read(run):
    spans = [(r.trace["first_packet"] - r.trace["first_frame"]) * 1e3 for r in run.requests
             if r.trace and "first_frame" in r.trace and "first_packet" in r.trace]
    return percentile(spans, 95)

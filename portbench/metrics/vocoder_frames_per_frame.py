"""Frames the vocoder computes per frame it delivers: rows x frames of
every egress and first-packet vocoder call, padding rows and left context
included (`server.vocode_frames_computed`), over the frames of the
packets sent (`server.vocode_frames_delivered`), counter deltas over the
window. 1 would be no work thrown away."""


def read(run):
    computed = run.counters.get("server.vocode_frames_computed")
    delivered = run.counters.get("server.vocode_frames_delivered")
    if not computed or not delivered:
        return None
    return computed / delivered

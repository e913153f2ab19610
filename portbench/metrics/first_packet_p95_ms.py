"""The 95th percentile (nearest rank) over every request submitted inside
the window of the time from its submit call to its first audio packet
(host clock). A request with no first packet counts with the time until the
harness stopped waiting for it."""

from portbench.harness import first_packet_ms, percentile


def read(run):
    return percentile(first_packet_ms(run), 95)

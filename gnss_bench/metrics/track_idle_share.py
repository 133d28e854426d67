"""The card's idle share inside the program's ``softgnss/track`` ranges of
the traced jobs, in %: how far the block tracker's host loop holds the
card back."""

from gnss_bench import trace

LAYER = "block tracker's host loop (track.scan.track_segments)"
UNIT = "%"
MOVES = "capture_rate"


def read(r):
    if r.trace is None:
        return None
    ranges = r.trace.ranges.get("softgnss/track", [])
    total = trace.length(ranges)
    if total <= 0 or not r.trace.device:
        return None
    return 100.0 * (1.0 - trace.busy_us(r.trace, ranges) / total)

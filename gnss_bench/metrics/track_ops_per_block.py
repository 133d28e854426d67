"""Device operations per block of the block tracker: every kernel, copy and
fill whose start lies inside a traced ``softgnss/track`` range and outside
its ``softgnss/track.to_host`` and ``softgnss/track.demote`` ranges, over
the ``softgnss/track.loop`` ranges times the blocks per tracking call (the
program's ``track_segments`` counters).  The stage waits for the card on
entry and ``track.wait`` before the outputs' copy, so each op the loop
launched is counted, and counts do not grow under the profiler."""

from gnss_bench.metrics.track_host_block_us import blocks_per_call

LAYER = "block tracker's host loop (track.scan.track_segments)"
UNIT = "ops"
MOVES = "capture_rate"


def _inside(t, ranges) -> bool:
    return any(a <= t < b for a, b in ranges)


def read(r):
    tr = r.trace
    if tr is None or not tr.device:
        return None
    track = tr.ranges.get("softgnss/track", [])
    loops = tr.ranges.get("softgnss/track.loop", [])
    blocks = blocks_per_call()
    if not track or not loops or blocks is None:
        return None
    out = tr.ranges.get("softgnss/track.to_host", []) + tr.ranges.get("softgnss/track.demote", [])
    n = sum(1 for a, _, _, _ in tr.device if _inside(a, track) and not _inside(a, out))
    return n / (len(loops) * blocks)

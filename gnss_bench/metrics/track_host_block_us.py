"""The host's time to issue one block of the block tracker, in us: the mean
of ``timings_s["track.loop"]`` over the window's jobs (the program's span
around ``track.scan.track_segments``' loop of B2/B1 calls and their glue)
over the blocks per tracking call, ``track_segments.segments /
track_segments.calls`` (the program's counters, read in this process)."""

LAYER = "block tracker's host loop (track.scan.track_segments)"
UNIT = "us"
MOVES = "capture_rate"


def blocks_per_call():
    """Segments per ``track_segments`` call in this process, or None where
    the program has no such counters or made no call."""
    try:
        from softgnss_tpu_torch.track.scan import track_segments
    except ImportError:
        return None
    calls = getattr(track_segments, "calls", 0)
    segments = getattr(track_segments, "segments", 0)
    return segments / calls if calls and segments else None


def read(r):
    xs = [t["track.loop"] for t in r.timings if "track.loop" in t]
    blocks = blocks_per_call()
    if not xs or blocks is None:
        return None
    return 1e6 * sum(xs) / len(xs) / blocks

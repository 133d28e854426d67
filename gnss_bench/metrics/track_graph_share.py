"""The share of the block tracker's segments that CUDA graph replays
issued, in %: ``track_segments.graph_blocks`` over
``track_segments.segments`` (the program's counters, read in this process,
as ``track_host_block_us`` reads its blocks per call).  A call's lead and
tail segments and its first full block run eagerly; every other full block
is a replay."""

LAYER = "block tracker's host loop (track.scan.track_segments)"
UNIT = "%"
MOVES = "capture_rate"


def read(r):
    try:
        from softgnss_tpu_torch.track.scan import track_segments
    except ImportError:
        return None
    calls = getattr(track_segments, "calls", 0)
    segments = getattr(track_segments, "segments", 0)
    graph_blocks = getattr(track_segments, "graph_blocks", None)
    if not calls or not segments or graph_blocks is None:
        return None
    return 100.0 * graph_blocks / segments

"""The share of the block tracker's B1 and B3 launches whose sample loop
takes its short path to the E/P/L chips, in %: ``short_launches`` over
``launches`` of ``megakernel.track_block`` and ``track_block_fused`` (the
program's counters, read in this process; a graph's replays counted).  The
short path serves a correlator spacing of half a chip: E and L are
adjacent chips read from one phase word (csrc/track_block.cu)."""

LAYER = "kernels (track.megakernel, csrc)"
UNIT = "%"
MOVES = "capture_rate"


def read(r):
    try:
        from softgnss_tpu_torch.track import megakernel as mk
    except ImportError:
        return None
    wrappers = (mk.track_block, mk.track_block_fused)
    if not all(hasattr(w, "short_launches") for w in wrappers):
        return None
    launches = sum(w.launches for w in wrappers)
    return 100.0 * sum(w.short_launches for w in wrappers) / launches if launches else None

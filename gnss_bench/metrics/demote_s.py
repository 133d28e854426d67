"""Lock demotion: the mean of ``timings_s["track.demote"]`` over every job
in the window, in s (the program's host-clock span around
``pipeline._demote_unlocked``, host NumPy inside the tracking stage)."""

LAYER = "block tracker (track.scan)"
UNIT = "s"
MOVES = "capture_rate"


def read(r):
    xs = [t["track.demote"] for t in r.timings if "track.demote" in t]
    return sum(xs) / len(xs) if xs else None

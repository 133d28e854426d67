"""The tracking stage's first sync: the mean of ``timings_s["track.wait"]``
over every job in the window, in s (the program's host-clock span around
``_check_overflow``, where the host waits for the queued blocks to drain)."""

LAYER = "block tracker (track.scan)"
UNIT = "s"
MOVES = "capture_rate"


def read(r):
    xs = [t["track.wait"] for t in r.timings if "track.wait" in t]
    return sum(xs) / len(xs) if xs else None

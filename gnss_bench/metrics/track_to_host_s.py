"""The copy of the tracking outputs to the host: the mean of
``timings_s["track.to_host"]`` over every job in the window, in s (the
program's host-clock span around the 14 outputs' ``.cpu().numpy()``)."""

LAYER = "block tracker (track.scan)"
UNIT = "s"
MOVES = "capture_rate"


def read(r):
    xs = [t["track.to_host"] for t in r.timings if "track.to_host" in t]
    return sum(xs) / len(xs) if xs else None

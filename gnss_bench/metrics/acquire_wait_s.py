"""Acquisition's wait: the mean of ``timings_s["acquire.wait"]`` over every
job in the window, in s (the program's host-clock span around the four
results' copies to the host, the first of which waits for the search)."""

LAYER = "acquisition (acquire.search)"
UNIT = "s"
MOVES = "capture_rate"


def read(r):
    xs = [t["acquire.wait"] for t in r.timings if "acquire.wait" in t]
    return sum(xs) / len(xs) if xs else None

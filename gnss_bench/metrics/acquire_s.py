"""Acquisition's stage time: the mean of ``timings_s["acquire"]`` over every
job in the window (the program's StageTimer, which waits for the card)."""

LAYER = "acquisition (acquire.search)"
UNIT = "s"
MOVES = "capture_rate"


def read(r):
    xs = [t["acquire"] for t in r.timings if "acquire" in t]
    return sum(xs) / len(xs) if xs else None

"""The tracking stage's time: the mean of ``timings_s["track"]`` over every
job in the window (the block loop, B2 and B1, the outputs' copy to the
host and lock demotion; StageTimer waits for the card)."""

LAYER = "block tracker (track.scan)"
UNIT = "s"
MOVES = "capture_rate"


def read(r):
    xs = [t["track"] for t in r.timings if "track" in t]
    return sum(xs) / len(xs) if xs else None

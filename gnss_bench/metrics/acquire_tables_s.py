"""Acquisition's tables: the mean of ``timings_s["acquire.tables"]`` over
every job in the window, in s (the program's host-clock spans around the
tables that hang on the configuration and the PRN list alone, built on the
host and moved to the card, once per job and once per PRN chunk)."""

LAYER = "acquisition (acquire.search)"
UNIT = "s"
MOVES = "capture_rate"


def read(r):
    xs = [t["acquire.tables"] for t in r.timings if "acquire.tables" in t]
    return sum(xs) / len(xs) if xs else None

"""The card's idle share over the traced window of whole jobs, in %."""

from gnss_bench import trace

LAYER = "device"
UNIT = "%"
MOVES = "capture_rate"


def read(r):
    if r.trace is None or not r.trace.device:
        return None
    lo, hi = r.trace.window
    return 100.0 * (1.0 - trace.busy_us(r.trace) / (hi - lo))

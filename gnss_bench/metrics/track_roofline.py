"""The tracking work's bound time over the device time of every kernel
inside the traced jobs' ``softgnss/track`` ranges, whatever their names,
in %.  The bound (gnss_bench.roofline) counts the same work whatever
implements it: channels x ms x samples per code x 90 operations at the
float32 peak, or the capture read once at peak bandwidth, the larger."""

from gnss_bench import roofline, trace

LAYER = "kernels (track.megakernel, csrc)"
UNIT = "%"
MOVES = "capture_rate"


def read(r):
    if r.trace is None or r.channels == 0:
        return None
    busy = trace.busy_us(r.trace, r.trace.ranges.get("softgnss/track", []), kernels_only=True)
    if busy <= 0:
        return None
    bound_us = r.traced_jobs * roofline.track_bound_s(r.channels, r.n_ms,
                                                      r.samples_per_code) * 1e6
    return 100.0 * bound_us / busy

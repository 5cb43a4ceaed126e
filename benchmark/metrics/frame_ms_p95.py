"""The 95th percentile (nearest rank), over every frame of the window, of
the milliseconds from one frame reaching host memory to the next; the
first frame is timed from the window's start."""
import math


def read(rec):
    t = rec.get("arrivals") or []
    if len(t) < 200:
        return None     # fewer than ten frames would lie beyond it
    gaps = sorted(b - a for a, b in zip([0.0] + t[:-1], t))
    return 1e3 * gaps[math.ceil(0.95 * len(gaps)) - 1]

"""Mean host milliseconds a frame of ``get_position()``, timed by the host
clock in the frames the traced run adds after its profiled window, where
the card is drained before each read: the copy into host memory, not the
wait for the period, and no profiler."""


def read(rec):
    ms = rec.get("read_ms") or []
    return sum(ms) / len(ms) if ms else None

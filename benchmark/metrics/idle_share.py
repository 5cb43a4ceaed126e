"""1 - the device's busy seconds (any operation running) over the traced
window's seconds."""


def read(rec):
    if not rec.get("busy_s"):
        return None
    return 1.0 - rec["busy_s"] / rec["window_s"]

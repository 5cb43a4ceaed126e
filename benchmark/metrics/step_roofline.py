"""The step's pair work at the card's peaks (``harness.work``: the pairs
within reach counted from positions) over the device's kernel seconds a
step, all kernels, in percent."""
from harness.work import bound_s


def read(rec):
    if not rec.get("kernel_s") or "work" not in rec:
        return None
    bound = sum(bound_s(rec["work"], rec["peaks"]).values())
    return 100.0 * bound / (rec["kernel_s"] / rec["steps"])

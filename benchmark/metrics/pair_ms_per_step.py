"""Device milliseconds a step of the pair kernels: the kernels whose names
hold one of ``data/pair_kernels.txt``."""
from harness.trace import kernel_seconds


def read(rec):
    if not rec.get("kernel_s"):
        return None
    return 1e3 * kernel_seconds(rec["kernel_time"],
                                rec["pair_kernels"]) / rec["steps"]

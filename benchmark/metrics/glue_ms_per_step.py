"""Device milliseconds a step of every kernel not on the pair-kernel list:
the engine's glue, its resort and the facade's own kernels."""
from harness.trace import kernel_seconds


def read(rec):
    if not rec.get("kernel_s"):
        return None
    pair = kernel_seconds(rec["kernel_time"], rec["pair_kernels"])
    return 1e3 * (rec["kernel_s"] - pair) / rec["steps"]

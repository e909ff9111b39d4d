"""Device time of the HT cleanup decode kernel (``ht_cleanup_kernel``) a
traced decode frame; nothing where no such kernel ran."""

from bench_port import arith
from bench_port.readers import kernel_seconds

KERNEL = "ht_cleanup_kernel"


def read(run):
    tr = run["trace"]
    if tr is None:
        return None
    frames = arith.frames_within(run["calls"], tr["t0"], tr["t1"], "decode")
    kernel_s = kernel_seconds(tr, KERNEL)
    if kernel_s <= 0 or frames <= 0:
        return None
    return kernel_s * 1e6 / frames

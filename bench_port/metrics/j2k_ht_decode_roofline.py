"""The HT cleanup decode kernel as a share of its HBM bound: the bytes it
writes for the traced decode frames (``ht_arith.bytes_per_frame``: each
coefficient once at the width the kernel writes; the cleanup bytes read
are not counted, the run's record holding no codestream sizes) over the
device time of the kernels named ``ht_cleanup_kernel`` alone; nothing
where no such kernel ran."""

from bench_port import arith, ht_arith
from bench_port.readers import kernel_seconds

KERNEL = "ht_cleanup_kernel"


def read(run):
    tr = run["trace"]
    if tr is None:
        return None
    frames = arith.frames_within(run["calls"], tr["t0"], tr["t1"], "decode")
    return arith.roofline_share(frames, ht_arith.bytes_per_frame(
        run["config"]), kernel_seconds(tr, KERNEL))

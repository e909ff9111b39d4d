"""The 5/3 inverse stage's kernel as a share of its HBM bound: the bytes
of the traced decode frames' stage (``arith.stage_bytes_per_frame``) over
the device time of the kernels named ``inv_stage_kernel`` alone."""

from bench_port.readers import stage_roofline


def read(run):
    return stage_roofline(run, "decode", "inv_stage_kernel")

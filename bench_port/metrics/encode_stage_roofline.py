"""The 5/3 forward stage's kernel as a share of its HBM bound: the bytes
of the traced encode frames' stage over the device time of the kernels
named ``fwd_stage_kernel`` alone."""

from bench_port.readers import stage_roofline


def read(run):
    return stage_roofline(run, "encode", "fwd_stage_kernel")

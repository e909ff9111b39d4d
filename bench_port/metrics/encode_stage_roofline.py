"""The encode calls' kernels as a share of the 5/3 stage's HBM bound."""

from bench_port.readers import stage_roofline


def read(run):
    return stage_roofline(run, "encode")

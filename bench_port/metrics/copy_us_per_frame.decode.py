"""Device us of copies per decoded frame, from the trace."""

from bench_port.readers import copy_us_per_frame


def read(run):
    return copy_us_per_frame(run, "decode")

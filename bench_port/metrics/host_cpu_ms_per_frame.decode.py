"""Host CPU ms per decoded frame, outside the profiled stretch."""

from bench_port.readers import host_cpu_ms_per_frame


def read(run):
    return host_cpu_ms_per_frame(run, "decode")

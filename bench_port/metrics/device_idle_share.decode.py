"""Share of the traced stretch of decode calls with the device idle."""

from bench_port.readers import device_idle_share


def read(run):
    return device_idle_share(run, "decode")

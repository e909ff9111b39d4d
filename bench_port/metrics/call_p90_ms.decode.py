"""90th percentile of a decode call's time, from the harness's spans."""

from bench_port.readers import call_p90_ms


def read(run):
    return call_p90_ms(run, "decode")

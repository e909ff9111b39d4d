"""90th percentile of a decode call's time, on the harness's clock
around each call of every client."""

from bench_port.readers import call_p90_ms


def read(run):
    return call_p90_ms(run, "decode")

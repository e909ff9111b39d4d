"""Frames/s of every decode call of every client over the whole window."""

from bench_port.readers import frames_per_s


def read(run):
    return frames_per_s(run, "decode")

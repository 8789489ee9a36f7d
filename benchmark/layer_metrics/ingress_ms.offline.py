"""Median host span of process_input (resize and pad) per image, ms."""

from benchmark import readers


def read(trace):
    return readers.median_ms(trace, "ingress")

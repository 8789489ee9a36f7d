"""Median host span of a batch's forward call (it returns after the forward's last host sync), ms."""

from benchmark import readers


def read(trace):
    return readers.median_ms(trace, "forward")

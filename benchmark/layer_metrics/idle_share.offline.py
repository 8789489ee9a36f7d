"""Percent of the traced window with no kernel, copy or set running on the device."""

from benchmark import readers


def read(trace):
    return readers.idle_share(trace)

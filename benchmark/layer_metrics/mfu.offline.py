"""Model FLOPs of the window's images over the window, percent of 989 TFLOP/s (bf16 dense)."""

from benchmark import readers


def read(trace):
    return readers.mfu(trace)

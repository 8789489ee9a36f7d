"""Median, over the window's images with a mask, of the paste loop's time (the program's ``unmold.masks`` span)
over the masks it pasted, us a mask."""

from benchmark import program_spans


def read(trace):
    return program_spans.median_us_per_unit(trace, "unmold.masks")

"""Median host span of unmold_detections per image, ms."""

from benchmark import readers


def read(trace):
    return readers.median_ms(trace, "unmold")

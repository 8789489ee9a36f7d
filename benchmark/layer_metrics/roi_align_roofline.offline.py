"""Pyramid ROIAlign forward (K2, K3) under ops/roi_align.py::pyramid_roi_align: percent of its bound."""

from benchmark import readers


def read(trace):
    return readers.roofline(trace, "bench::roi_align")

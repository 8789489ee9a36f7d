"""Greedy NMS (K1) under ops/nms.py::non_max_suppression: percent of its bound."""

from benchmark import readers


def read(trace):
    return readers.roofline(trace, "bench::nms")

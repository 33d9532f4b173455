"""The five kernels' share of their roofline on the offline path."""
from benchmark.readers import kernels_roofline


def read(record):
    return kernels_roofline(record, "offline")

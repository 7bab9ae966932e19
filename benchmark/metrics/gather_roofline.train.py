from benchmark.readers import roofline


def read(r):
    """Kernel 2 (csrc/gather.cu): least time over device time, %."""
    return roofline(r, "gather")

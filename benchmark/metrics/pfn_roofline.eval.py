from benchmark.readers import roofline


def read(r):
    """Kernel 1 (csrc/pfn.cu): least time over device time, %."""
    return roofline(r, "pfn")

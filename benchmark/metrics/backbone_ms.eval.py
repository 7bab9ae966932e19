from benchmark.readers import range_ms


def read(r):
    """Device ms a batch of the kernels the backbone launches."""
    return range_ms(r, "backbone", device=True)

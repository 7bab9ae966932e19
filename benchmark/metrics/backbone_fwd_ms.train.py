from benchmark.readers import range_ms


def read(r):
    """Device ms a step of the kernels the backbone's forward launches."""
    return range_ms(r, "backbone", device=True)

from benchmark.readers import host_mfu


def read(r):
    """A batch's reference forward FLOPs a second over the untraced
    stretch, % of the bf16 peak."""
    return host_mfu(r)

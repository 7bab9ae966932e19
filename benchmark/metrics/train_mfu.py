from benchmark.readers import mfu


def read(r):
    """A training step's reference FLOPs (backward twice the forward) a second, % of the bf16 peak."""
    return mfu(r)

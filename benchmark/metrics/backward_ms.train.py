from benchmark.spans import backward_ms


def read(r):
    """Device ms a step of the kernels launched while ``train.backward``
    was open, on autograd's device thread too (a recompute included)."""
    return backward_ms(r)

from benchmark.spans import span_ms


def read(r):
    """Device ms a step of the kernels ``model.loss`` launches (the
    program's ``train.forward`` spans)."""
    return span_ms(r, "train.forward")

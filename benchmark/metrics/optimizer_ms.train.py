from benchmark.spans import span_ms


def read(r):
    """Device ms a step of the global norm, clip and AdamW (the program's
    ``train.optimizer`` spans)."""
    return span_ms(r, "train.optimizer")

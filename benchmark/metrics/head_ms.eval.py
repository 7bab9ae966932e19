from benchmark.spans import span_ms


def read(r):
    """Device ms a batch of the head, its decode, top-k and NMS (the
    program's ``model.head`` spans)."""
    return span_ms(r, "model.head")

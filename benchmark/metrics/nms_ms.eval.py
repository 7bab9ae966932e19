from benchmark.spans import span_ms


def read(r):
    """Device ms a batch of the streaming NMS (the program's ``nms``
    spans), its host reads included."""
    return span_ms(r, "nms")

from benchmark.spans import span_ms


def read(r):
    """Device ms a step of the MVF towers' blocks (the program's
    ``mvf.tower`` spans): their forward, and their recompute in the
    backward, which replays the span."""
    return span_ms(r, "mvf.tower")

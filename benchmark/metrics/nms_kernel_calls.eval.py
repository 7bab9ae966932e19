from benchmark.spans import span_count


def read(r):
    """Calls of the NMS kernel a batch (the program's ``nms.kernel`` spans,
    one a group of task heads that share a stride); None where the program
    has no such span."""
    return span_count(r, "nms.kernel")

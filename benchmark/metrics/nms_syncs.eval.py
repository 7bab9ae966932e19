from benchmark.spans import span_count


def read(r):
    """The NMS's host reads a batch (the program's ``nms.sync`` spans):
    one a 128-candidate chunk and one a fixpoint round."""
    return span_count(r, "nms.sync")

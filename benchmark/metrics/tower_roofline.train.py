from benchmark import counts
from benchmark.spans import span_ms


def read(r):
    """The MVF towers' least time a step (``extra["tower_cost"]``: the
    bytes and FLOPs of the passes the ``mvf.tower`` spans hold, from
    ``counts_mvf.py``) over their device time, %."""
    ms = span_ms(r, "mvf.tower")
    cost = r.extra.get("tower_cost")
    if ms is None or not cost:
        return None
    return 100.0 * counts.least_seconds(*cost) / (ms / 1e3)

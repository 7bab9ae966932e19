import bisect

from benchmark.readers import per_item
from benchmark.spans import _clashed_us, span_ms


def read(r):
    """Device ms a step of the MVF reader's forward outside its towers:
    the program's ``model.reader`` spans less the ``mvf.tower`` spans that
    start inside them (the views' decoration, PFNs and densifies, the
    readbacks, the PointNets and the coarse max).  None where the program
    opens no ``mvf.tower`` span."""
    reader = span_ms(r, "model.reader")
    if reader is None:
        return None
    windows = sorted((s, e) for n, s, e, _ in r.profile.host if n == "model.reader")
    starts = [s for s, _ in windows]
    towers = []
    for n, s, e, d in r.profile.host:
        i = bisect.bisect_right(starts, s) - 1
        if n == "mvf.tower" and i >= 0 and s <= windows[i][1]:
            towers.append((s, e, d))
    if not towers:
        return None
    tower_us = sum(d for _, _, d in towers) - _clashed_us(r.profile.host, sorted((s, e) for s, e, _ in towers))
    return reader - tower_us / 1e3 / per_item(r)

from benchmark.readers import host_idle


def read(r):
    """The share of an untraced batch with no kernel on the card, %."""
    return host_idle(r)

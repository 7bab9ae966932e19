from benchmark.readers import idle


def read(r):
    """The share of the traced stretch with no kernel on the card, %."""
    return idle(r)

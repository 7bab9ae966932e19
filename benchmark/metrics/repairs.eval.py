def read(r):
    """Batches the AdaptivePredictor recomputed at its largest bucket in the traced stretch."""
    return float(r.repairs)

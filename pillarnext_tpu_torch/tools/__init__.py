"""The port's learning checks: ``overfit_sanity`` and ``metric_delta``."""

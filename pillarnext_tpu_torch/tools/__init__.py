"""The port's learning checks (``overfit_sanity``, ``metric_delta``) and
its full-scale parity harness (``flagship_parity``, ``voxel_parity``,
``mvf_parity`` against the reference mirrors ``reference_mirror*``, with
what they share in ``parity``)."""

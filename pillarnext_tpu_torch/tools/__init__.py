"""The port's learning checks (``overfit_sanity``, ``metric_delta``), its
full-scale parity harness (``flagship_parity``, ``voxel_parity``,
``mvf_parity`` against the reference mirrors ``reference_mirror*``, with
what they share in ``parity``), its measurement tools (``eval_breakdown``,
``train_breakdown``, ``loader_bench``, ``baseline_probe``) and the
multi-host Waymo launcher (``dist_train_waymo.sh``)."""

"""Command-line entry points (counterparts of pillarnext_tpu/cli):
``python -m pillarnext_tpu_torch.cli.train``, ``.cli.test``, and the
offline data preparation ``.cli.create_data`` and ``.cli.create_gt_database``."""

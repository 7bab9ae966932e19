"""Command-line entry points (counterparts of pillarnext_tpu/cli):
``python -m pillarnext_tpu_torch.cli.train`` and ``.cli.test``."""

#!/usr/bin/env python
"""Import a checkpoint of the reference into a checkpoint of the port.

Counterpart of tools/import_checkpoint.py: reads a checkpoint written by
the reference (qcraftai/pillarnext, such as the released PillarNeXt-B
weights: a bare state_dict or one under ``state_dict`` / ``model``,
``module.`` prefixes, spconv's (O, kH, kW, I) sparse kernels,
``num_batches_tracked``), carries it into the experiment's model
(``utils/torch_import.state_dict_from_reference``, which raises on a
missing, stray or misshapen tensor) and writes ``<out>/epoch_0.pt``
with a fresh optimizer state, which ``cli.test --checkpoint`` and
``cli.train --load-from`` read unchanged.  Pillar-family experiments
only, as in JAX.

    python -m pillarnext_tpu_torch.cli.import_checkpoint \\
        --config pillarnext_tpu/configs/experiments/nusc_det_pp18_aspp_iou_sp.yaml \\
        --torch-checkpoint pillarnext-b.pth --out work_dir/imported [key.path=value ...] \\
        [--device cuda:N|cpu]
    (or: pnx-torch-import-checkpoint ...)

    python -m pillarnext_tpu_torch.cli.test --config ... \\
        --checkpoint work_dir/imported/epoch_0.pt
"""

from __future__ import annotations

import argparse
from pathlib import Path

from pillarnext_tpu_torch.models.pillar_encoder import PillarFeatureNet
from pillarnext_tpu_torch.train import checkpoint as ckpt_lib
from pillarnext_tpu_torch.utils import builders
from pillarnext_tpu_torch.utils.config import load_experiment
from pillarnext_tpu_torch.utils.torch_import import load_torch_state_dict, state_dict_from_reference


def main(argv=None) -> Path:
    p = argparse.ArgumentParser(description="Import a reference PillarNeXt checkpoint into the PyTorch / CUDA port.")
    p.add_argument("--config", required=True)
    p.add_argument("--torch-checkpoint", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--device", default="cuda:0", help="where the model is built (cpu without a card)")
    p.add_argument("overrides", nargs="*", help="config overrides key.path=value (+key.path=value adds)")
    args = p.parse_args(argv)

    cfg = load_experiment(args.config, args.overrides)
    model = builders.build_model(cfg["model"], device=args.device)
    if not isinstance(model.reader, PillarFeatureNet):
        raise ValueError(f"reference checkpoints import into the pillar family, not a {type(model.reader).__name__}")
    model.load_state_dict(state_dict_from_reference(load_torch_state_dict(args.torch_checkpoint), model),
                          strict=True)
    opt, _ = builders.build_optimizer(cfg, 1, list(model.parameters()))
    path = ckpt_lib.save_checkpoint(args.out, 0, model, opt)
    n = sum(p.numel() for p in model.parameters())
    print(f"imported {n / 1e6:.2f}M params -> {path}")
    return path


if __name__ == "__main__":
    main()

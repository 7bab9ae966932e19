#!/bin/bash
# Multi-host Waymo training launcher of the PyTorch port: 4 hosts x 8 cards,
# global batch 96 (3 a card), the reference's torchrun recipe
# (tools/dist_train_waymo.sh).  Run once per host with PROCESS_ID=0..N-1;
# torchrun starts NPROC_PER_NODE ranks on the host, and each joins the group
# through parallel.init_from_env (the training CLI calls it).
#
#   COORDINATOR=host0:29500 PROCESS_ID=$i [NUM_PROCESSES=4] [NPROC_PER_NODE=8] \
#     bash pillarnext_tpu_torch/tools/dist_train_waymo.sh [--device ...] [key.path=value ...]
#
# COORDINATOR is host 0's address and a free port; arguments after the
# launcher's own overrides reach the CLI (later overrides win).  PYTHON
# names the interpreter (default: python).
set -euo pipefail

COORDINATOR="${COORDINATOR:?set COORDINATOR=host0:port}"
PROCESS_ID="${PROCESS_ID:?set PROCESS_ID}"
NUM_PROCESSES="${NUM_PROCESSES:-4}"
NPROC_PER_NODE="${NPROC_PER_NODE:-8}"
REPO="$(cd "$(dirname "${BASH_SOURCE[0]}")/../.." && pwd)"
export PYTHONPATH="${REPO}${PYTHONPATH:+:${PYTHONPATH}}"

exec "${PYTHON:-python}" -m torch.distributed.run \
  --nnodes="${NUM_PROCESSES}" --node_rank="${PROCESS_ID}" --nproc_per_node="${NPROC_PER_NODE}" \
  --master_addr="${COORDINATOR%:*}" --master_port="${COORDINATOR##*:}" \
  -m pillarnext_tpu_torch.cli.train \
  --config "${REPO}/pillarnext_tpu/configs/experiments/waymo_det_pp18_aspp_iou_car_sp.yaml" \
  dataloader.train.batch_size=3 \
  scheduler.max_lr=0.006 \
  trainer.max_epochs=36 \
  "$@"

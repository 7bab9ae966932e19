"""Training (counterparts of pillarnext_tpu/train): optimizer, step,
trainer, checkpoints."""

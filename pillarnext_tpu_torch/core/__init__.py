"""Box geometry and NMS (counterparts of pillarnext_tpu/core)."""

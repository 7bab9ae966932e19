"""Host-side data (counterparts of pillarnext_tpu/data): target assignment
and static-shape collation."""

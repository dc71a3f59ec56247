"""Training: checkpointing (atomic, keep-k, async), AdamW with a
warmup-cosine schedule, int8 gradient compression with error feedback, and
the restartable train loop."""

"""Checkpointing (atomic, keep-k, async) of flat array dicts."""

"""Synthetic corpora (a copy of the JAX package's generators) and the
index's data clients: dedup / contamination screening and the LM batch
loader."""

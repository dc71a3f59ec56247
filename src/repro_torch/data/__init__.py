"""Synthetic corpora (a copy of the JAX package's generators)."""

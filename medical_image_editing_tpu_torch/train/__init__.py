"""Inference-side counterparts of the JAX package's `train/` modules."""

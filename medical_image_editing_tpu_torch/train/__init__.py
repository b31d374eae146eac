"""Counterparts of the JAX package's `train/` modules: the eval forward, the
first-stage step and its train state."""

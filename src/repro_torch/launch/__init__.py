"""Cost models of task bodies (the JAX package's `repro/launch/` counterpart)."""

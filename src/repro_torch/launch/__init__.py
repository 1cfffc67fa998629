"""Meshes, abstract inputs, the dry run and its cost model (the JAX
package's `repro/launch/` counterpart)."""

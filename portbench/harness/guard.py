"""The import guard: the port runs without JAX and without the JAX package.

Top-level module names are compared whole (the part before the first dot):
`repro_torch`, the port, begins with `repro`, the JAX package, and is no
match for it.
"""
from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(modules=None) -> list[str]:
    """The loaded top-level names that the port must not load."""
    names = {m.split(".", 1)[0] for m in (sys.modules if modules is None else modules)}
    return sorted(n for n in names if n in FORBIDDEN)

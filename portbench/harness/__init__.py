"""The benchmark's own machinery: reading the spec, running a cell, timing,
tracing and judging it."""

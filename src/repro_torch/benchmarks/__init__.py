"""Benchmarks of the port that drive the scheduling stack on a device."""

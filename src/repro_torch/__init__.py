"""PyTorch and CUDA port of the JAX package `repro`, for one NVIDIA H100.

The JAX package stays as the reference; this package mirrors its tree and
names and imports nothing of it.  Entry points run on `cuda` unless the
caller passes `device="cpu"`; without a card they raise.
"""

"""PyTorch/CUDA port of ``repro`` for NVIDIA Hopper: serving, the
full-sequence forward, training, training on transient servers and the
trace-driven gym with its planning layer.

The JAX package ``repro`` is the reference; this package keeps its module
names so each counterpart is easy to find, and imports nothing from it.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

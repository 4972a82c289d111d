"""PyTorch/CUDA port of the ``repro`` serving path, for NVIDIA Hopper.

The JAX package ``repro`` is the reference; this package keeps its module
names so each counterpart is easy to find, and imports nothing from it.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

"""PyTorch/CUDA port of ``repro`` for NVIDIA Hopper: the dense serving path,
the full-sequence forward and the dense training path.

The JAX package ``repro`` is the reference; this package keeps its module
names so each counterpart is easy to find, and imports nothing from it.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

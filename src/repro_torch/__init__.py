"""PyTorch/CUDA port of the HetRL reproduction (``repro``), slice by slice.

The JAX package ``repro`` is the reference; this package imports none of
it and no JAX.  Slice 1 is the serving path: ``launch.serve`` ->
``genserve`` -> ``models.transformer`` -> the hand-written CUDA
flash-attention and flash-decode kernels (``kernels``, ``csrc``).
Entry points run on the card (``cuda``) unless the caller passes
``device="cpu"``.
"""

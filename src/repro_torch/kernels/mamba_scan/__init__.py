"""Mamba selective scan: CUDA kernel wrapper and plain version (``ops``)."""

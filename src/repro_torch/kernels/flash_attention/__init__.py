"""Flash attention: CUDA kernel wrapper and plain version (``ops``)."""

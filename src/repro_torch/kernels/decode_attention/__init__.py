"""Flash-decode: CUDA kernel wrapper and plain version (``ops``)."""

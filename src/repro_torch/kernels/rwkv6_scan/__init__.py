"""RWKV6 chunked scan: CUDA kernel wrapper and plain version (``ops``)."""

"""The port's hand-written CUDA kernels (``csrc/``), their wrappers and
plain PyTorch versions, and the routing adapter (``ops``)."""

"""Checkpoints in the JAX package's file format (``io``), written and read
with this package's own msgpack-subset codec (``codec``)."""

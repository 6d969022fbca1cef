"""PyTorch/CUDA port of the HetRL reproduction (``repro``), slice by slice.

The JAX package ``repro`` is the reference; this package imports none of
it and no JAX.  The serving path: ``launch.serve`` -> ``genserve`` ->
``models.transformer`` -> the hand-written CUDA kernels (``kernels``,
``csrc``).  The RL path: ``launch.train --rl`` -> the scheduler
(``core``) -> ``Plan`` -> ``engine`` (GEN through ``genserve``, INF,
TRAIN on the plain attention with autograd and ``optim.adam``, weight
sync) driven by ``rl.trainer``.  Entry points run on the card (``cuda``)
unless the caller passes ``device="cpu"``.
"""

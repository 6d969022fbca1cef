"""Sharded execution on torch.distributed: partition rules and hints on
DTensor (``sharding``), and the process world with its exchange helpers
(``dist``)."""

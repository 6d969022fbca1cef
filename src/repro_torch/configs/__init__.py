"""Architecture configs (a copy of ``repro.configs``)."""

"""Model zoo of the port: config, layers, attention, caches, assembly, sampling."""

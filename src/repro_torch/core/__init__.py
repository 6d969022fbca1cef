"""Host-side planning helpers the port's serving path needs."""

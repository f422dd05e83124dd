"""Per-architecture configs of the port (the dense family) + registry."""

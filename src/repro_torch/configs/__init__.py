"""Per-architecture configs of the port (dense, MoE, SSM, hybrid) + registry."""

"""Sharding of the port: the mesh-sharded federation server (``fed_rules``)."""

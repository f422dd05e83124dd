"""Federated simulation of the port: cost model and the round loop."""

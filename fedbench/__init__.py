"""Benchmark of the PyTorch/CUDA port of FedScalar: see run.py."""

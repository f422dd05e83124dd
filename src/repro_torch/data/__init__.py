"""Data pipelines (numpy copies of ``repro.data``): digits and client splits."""
from repro_torch.data.digits import load_digits, train_test_split_arrays
from repro_torch.data.partition import make_client_datasets, partition_dirichlet, partition_iid

__all__ = [
    "load_digits", "train_test_split_arrays",
    "make_client_datasets", "partition_dirichlet", "partition_iid",
]

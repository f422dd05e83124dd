"""The paper's own evaluation model: 64-24-12-10 MLP, d≈2000 (§III).

Counterpart of ``repro/configs/paper_mlp.py``.  Like the reference's, it
is not registered in :mod:`repro_torch.configs.registry`: the digits
pipeline builds the model with :mod:`repro_torch.models.mlp_classifier`.
"""
from repro_torch.models.config import ModelConfig

# Represented via ModelConfig for uniformity with the registered archs.
CONFIG = ModelConfig(
    name="paper-mlp",
    arch_type="mlp",
    num_layers=2,
    d_model=24,
    vocab_size=10,
    use_rope=False,
    dtype="float32",
    source="FedScalar §III",
)

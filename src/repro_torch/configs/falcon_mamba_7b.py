"""falcon-mamba-7b [ssm]: attention-free Mamba-1. [arXiv:2410.05355]

64L d_model=4096 (attn-free) vocab=65024, ssm_state=16, expand=2.
O(1) recurrent state per layer at decode.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    arch_type="ssm",
    num_layers=64,
    d_model=4096,
    vocab_size=65024,
    ssm_state=16,
    ssm_conv=4,
    ssm_expand=2,
    use_rope=False,
    source="arXiv:2410.05355",
)

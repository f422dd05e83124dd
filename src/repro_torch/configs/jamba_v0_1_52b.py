"""jamba-v0.1-52b [hybrid]: Mamba+attn 1:7 interleave, MoE. [arXiv:2403.19887]

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536, MoE 16e top-2.
Period-8 blocks: attention at in-period offset 4, mamba elsewhere;
MoE FFN every second layer (16 MoE layers total).  ≈ 104 GB of bf16
parameters: one card holds 2 of its 4 periods.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    arch_type="hybrid",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    num_experts=16,
    experts_per_token=2,
    attn_period=8,
    attn_offset=4,
    moe_period=2,
    ssm_state=16,
    ssm_conv=4,
    ssm_expand=2,
    source="arXiv:2403.19887",
)

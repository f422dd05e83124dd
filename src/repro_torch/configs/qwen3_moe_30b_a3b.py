"""qwen3-moe-30b-a3b [moe]: 128 experts top-8. [hf:Qwen/Qwen3-30B-A3B]

48L d_model=2048 32H (GQA kv=4) d_ff=768 (per expert) vocab=151936.
head_dim resolves to 2048 / 32 = 64 and there is no qk-norm, as in the
reference's config (the public config.json has head_dim 128).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    arch_type="moe",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    d_ff=768,
    vocab_size=151936,
    num_experts=128,
    experts_per_token=8,
    rope_theta=1e6,
    source="hf:Qwen/Qwen3-30B-A3B",
)

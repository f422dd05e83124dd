"""qwen3-moe-235b-a22b [moe]: 128 experts top-8. [hf:Qwen/Qwen3-235B-A22B]

94L d_model=4096 64H (GQA kv=4) d_ff=1536 (per expert) vocab=151936.
The reference's figures; its file cites the 30B card, the port the
235B one.  ≈ 470 GB of bf16 parameters: on one card it runs reduced.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    arch_type="moe",
    num_layers=94,
    d_model=4096,
    num_heads=64,
    num_kv_heads=4,
    d_ff=1536,
    vocab_size=151936,
    num_experts=128,
    experts_per_token=8,
    rope_theta=1e6,
    source="hf:Qwen/Qwen3-235B-A22B",
)

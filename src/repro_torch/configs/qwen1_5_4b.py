"""qwen1.5-4b [dense]: QKV bias. [hf:Qwen/Qwen1.5-0.5B]

40L d_model=2560 20H (MHA kv=20) d_ff=6912 vocab=151936.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-4b",
    arch_type="dense",
    num_layers=40,
    d_model=2560,
    num_heads=20,
    num_kv_heads=20,
    d_ff=6912,
    vocab_size=151936,
    qkv_bias=True,
    rope_theta=1e6,
    source="hf:Qwen/Qwen1.5-0.5B",
)

"""paligemma-3b [vlm]: SigLIP + gemma backbone. [arXiv:2407.07726]

18L d_model=2048 8H (GQA kv=1, MQA) d_ff=16384 vocab=257216.
The SigLIP vision tower + projector are stubbed, as in the reference:
the model takes 256 patch embeddings of width 2048 (``embeds``) before
the text tokens.  The image+prompt prefix attends bidirectionally
(prefix-LM), matching PaliGemma's attention pattern.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    arch_type="vlm",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    head_dim=256,                # gemma-2b head_dim
    d_ff=16384,
    vocab_size=257216,
    frontend="vision",
    num_frontend_tokens=256,
    prefix_bidirectional=256,
    activation="geglu",
    tie_embeddings=True,
    source="arXiv:2407.07726",
)

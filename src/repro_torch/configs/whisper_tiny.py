"""whisper-tiny [audio]: enc-dec, conv frontend stubbed. [arXiv:2212.04356]

4L (encoder + decoder) d_model=384 6H (GQA kv=6) d_ff=1536 vocab=51865.
The mel-spectrogram + conv1d feature extractor is stubbed, as in the
reference: the encoder takes the (B, 1500, 384) frame embeddings the
conv stack would produce for 30 s of audio (``embeds``).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    arch_type="encdec",
    num_layers=4,                 # decoder layers
    encoder_layers=4,
    encoder_seq=1500,             # 30 s of audio after 2× conv downsampling
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    d_ff=1536,
    vocab_size=51865,
    frontend="audio",
    norm="layernorm",
    activation="gelu",
    use_rope=False,
    max_position=4096,            # learned decoder positions (mod for long shapes)
    qkv_bias=True,                # whisper uses biased projections
    tie_embeddings=True,
    source="arXiv:2212.04356",
)

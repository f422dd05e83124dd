"""minitron-8b [dense]: pruned nemotron. [arXiv:2407.14679]

32L d_model=4096 32H (GQA kv=8) d_ff=16384 vocab=256000.
Nemotron-family non-gated squared-ReLU MLP.

This entry mirrors the reference's, field for field, and the parity tests
hold it to the JAX package.  The published model
(hf:nvidia/Minitron-8B-Base, ``config.json``) differs from it in three
places: 48 query heads of 128 (a query width of 6144 over the 4096 hidden
size) over the same 8 K/V heads; rotary positions over the first 64 of
each head's 128 dims (``partial_rotary_factor`` 0.5), the other 64 passed
through; and Nemotron's ``layernorm1p``, which stores the norm's scale
less one (in exact arithmetic the same forward and SGD step as a scale
that starts at 1, which the port keeps).
The benchmark runs the published widths: ``fedbench/configs/
minitron-8b-base.json``, built over this entry with ``dataclasses.replace``.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="minitron-8b",
    arch_type="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=16384,
    vocab_size=256000,
    activation="relu2",
    norm="layernorm",
    source="arXiv:2407.14679",
)

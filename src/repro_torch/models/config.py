"""Unified model configuration (counterpart of ``repro/models/config.py``).

One ``ModelConfig`` describes dense decoder-only LMs, GQA/MQA variants,
MoE layers, Mamba-1 SSM stacks, hybrid (Jamba) interleaves, enc-dec
(Whisper) and stub-fronted multimodal (PaliGemma / Whisper audio)
backbones.  ``repro_torch/configs/<arch>.py`` instantiates one of these
per ported architecture; reduced variants (for CPU smoke tests) shrink
layers/width only.  A copy of the reference's dataclass, field for
field, with ``torch_dtype`` in place of ``jnp_dtype``, and one field of
the port's own: ``partial_rotary_factor``, the share of each head that
rotary positions rotate (Nemotron's 0.5; the rest of the head passes
through).  Its default, 1.0, is the whole head, as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

__all__ = ["ModelConfig"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                    # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int = 0                # 0 for attention-free (ssm)
    num_kv_heads: int = 0
    d_ff: int = 0
    vocab_size: int = 32000
    head_dim: int = 0                 # 0 → d_model // num_heads

    # --- MoE ---
    num_experts: int = 0              # 0 → dense FFN
    experts_per_token: int = 0
    capacity_factor: float = 1.25

    # --- SSM (Mamba-1) ---
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_dt_rank: int = 0              # 0 → ceil(d_model / 16)

    # --- hybrid (Jamba): one attention layer every `attn_period` layers ---
    attn_period: int = 0              # 0 → not hybrid; Jamba: 8 (1 attn : 7 mamba)
    moe_period: int = 0               # Jamba: MoE FFN every 2 layers
    attn_offset: int = 0              # index of the attn layer within a period

    # --- encoder-decoder (Whisper) ---
    encoder_layers: int = 0           # >0 → enc-dec; num_layers = decoder layers
    encoder_seq: int = 0              # fixed encoder length (whisper: 1500 frames)

    # --- multimodal frontend stub ---
    frontend: str = "none"            # none | audio | vision
    num_frontend_tokens: int = 0      # vision: 256 patch embeddings

    # --- options ---
    qkv_bias: bool = False            # qwen1.5 style
    activation: str = "swiglu"        # swiglu | gelu | geglu
    norm: str = "rmsnorm"             # rmsnorm | layernorm
    rope_theta: float = 10000.0
    partial_rotary_factor: float = 1.0  # the port's own field (module docstring)
    use_rope: bool = True             # whisper uses learned absolute positions
    max_position: int = 0             # for learned positions (0 = unused)
    tie_embeddings: bool = False
    window: int = 0                   # sliding-window attention (0 = full/causal)
    prefix_bidirectional: int = 0     # paligemma: first P tokens attend bidirectionally

    dtype: str = "bfloat16"
    source: str = ""                  # citation (paper / model card)

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.num_heads, 1)

    @property
    def rotary_dim(self) -> int:
        """The dims of each query and key head that rotary positions rotate."""
        return int(self.partial_rotary_factor * self.resolved_head_dim)

    @property
    def resolved_dt_rank(self) -> int:
        if self.ssm_dt_rank:
            return self.ssm_dt_rank
        return -(-self.d_model // 16)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def torch_dtype(self) -> torch.dtype:
        return {"bfloat16": torch.bfloat16, "float32": torch.float32}[self.dtype]

    def layer_kind(self, i: int) -> str:
        """'attn' | 'mamba' for layer i (hybrid interleave logic)."""
        if self.arch_type == "ssm":
            return "mamba"
        if self.attn_period:
            return "attn" if (i % self.attn_period) == self.attn_offset else "mamba"
        return "attn"

    def ffn_kind(self, i: int) -> str:
        """'moe' | 'dense' | 'none' for layer i's FFN."""
        if self.arch_type == "ssm":
            return "none"                      # mamba blocks have no separate FFN
        if self.num_experts:
            if self.moe_period:
                return "moe" if (i % self.moe_period) == 1 else "dense"
            return "moe"
        return "dense"

    def reduced(self, num_layers: int = 2, d_model: int = 256, d_ff: int = 512,
                vocab_size: int = 512, num_experts: Optional[int] = None) -> "ModelConfig":
        """CPU-smoke-test variant of the same family (spec: ≤2L, ≤512 width)."""
        heads = min(self.num_heads, 4) if self.num_heads else 0
        kv = 0
        if self.num_kv_heads:
            kv = max(1, min(self.num_kv_heads, heads))
            while heads % kv:
                kv -= 1
        ne = self.num_experts
        if ne:
            ne = num_experts if num_experts is not None else min(4, ne)
        period = self.attn_period
        if period:
            num_layers = max(num_layers, period)  # keep ≥1 attn + mamba mix
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            num_layers=num_layers,
            d_model=d_model,
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=(d_model // heads) if heads else 0,
            d_ff=d_ff,
            vocab_size=vocab_size,
            num_experts=ne,
            experts_per_token=min(self.experts_per_token, ne) if ne else 0,
            encoder_layers=min(self.encoder_layers, 2),
            encoder_seq=min(self.encoder_seq, 64) if self.encoder_seq else 0,
            num_frontend_tokens=min(self.num_frontend_tokens, 16)
            if self.num_frontend_tokens else 0,
            ssm_dt_rank=16 if self.ssm_state else 0,
            max_position=min(self.max_position, 512) if self.max_position else 0,
            dtype="float32",
        )

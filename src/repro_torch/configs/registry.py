"""Architecture registry: ``--arch <id>`` → ModelConfig / Arch.

The port carries all ten of the reference's configs, in its order: the
dense, MoE, SSM and hybrid decoder-only families, the VLM (PaliGemma,
through the decoder-only stack with its stubbed vision embeddings) and
the enc-dec (Whisper, ``models/encdec.py``).  The paper's MLP
(``configs/paper_mlp.py``) is ported but, as in the reference, not
registered.
"""
from __future__ import annotations

from repro_torch.configs import (
    falcon_mamba_7b,
    granite_8b,
    jamba_v0_1_52b,
    minitron_8b,
    paligemma_3b,
    qwen1_5_4b,
    qwen3_moe_30b_a3b,
    qwen3_moe_235b_a22b,
    smollm_360m,
    whisper_tiny,
)
from repro_torch.models.api import Arch
from repro_torch.models.config import ModelConfig

__all__ = ["CONFIGS", "ARCH_IDS", "NOT_PORTED", "get_config", "get_arch"]

CONFIGS: dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (whisper_tiny, qwen3_moe_30b_a3b, qwen3_moe_235b_a22b,
              paligemma_3b, qwen1_5_4b, falcon_mamba_7b, granite_8b,
              minitron_8b, smollm_360m, jamba_v0_1_52b)
}

ARCH_IDS = tuple(CONFIGS)

# Ported but unregistered, as in the reference: the digits pipeline
# builds the paper's MLP with models/mlp_classifier.py.
_UNREGISTERED = {"paper-mlp": "repro_torch.configs.paper_mlp.CONFIG"}

# The reference's architectures whose families the port does not carry:
# none left.
NOT_PORTED = ()


def get_config(name: str) -> ModelConfig:
    if name in _UNREGISTERED:
        raise KeyError(f"arch {name!r} is ported but not registered, as in "
                       f"the reference: its config is {_UNREGISTERED[name]} "
                       "and models/mlp_classifier.py builds it")
    if name not in CONFIGS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(CONFIGS)}")
    return CONFIGS[name]


def get_arch(name: str, reduced: bool = False) -> Arch:
    cfg = get_config(name)
    if reduced:
        cfg = cfg.reduced()
    return Arch(cfg)

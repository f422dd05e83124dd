"""Architecture registry: ``--arch <id>`` → ModelConfig / Arch.

The port carries the dense decoder-only family.  The reference's other
families (MoE, SSM, hybrid, enc-dec, VLM) are named here so that asking
for one says where it stands instead of "unknown arch".  The paper's
MLP (``configs/paper_mlp.py``) is ported but, as in the reference, not
registered.
"""
from __future__ import annotations

from repro_torch.configs import granite_8b, minitron_8b, qwen1_5_4b, smollm_360m
from repro_torch.models.api import Arch
from repro_torch.models.config import ModelConfig

__all__ = ["CONFIGS", "ARCH_IDS", "NOT_PORTED", "get_config", "get_arch"]

CONFIGS: dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (qwen1_5_4b, granite_8b, minitron_8b, smollm_360m)
}

ARCH_IDS = tuple(CONFIGS)

# Ported but unregistered, as in the reference: the digits pipeline
# builds the paper's MLP with models/mlp_classifier.py.
_UNREGISTERED = {"paper-mlp": "repro_torch.configs.paper_mlp.CONFIG"}

# The reference's architectures whose families the port does not carry yet.
NOT_PORTED = ("whisper-tiny", "qwen3-moe-30b-a3b", "qwen3-moe-235b-a22b",
              "paligemma-3b", "falcon-mamba-7b", "jamba-v0.1-52b")


def get_config(name: str) -> ModelConfig:
    if name in NOT_PORTED:
        raise KeyError(f"arch {name!r} is not ported yet: its family (MoE, "
                       "SSM, hybrid, enc-dec or VLM) comes with its modules "
                       "(ROADMAP A10)")
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

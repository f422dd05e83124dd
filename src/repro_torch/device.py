"""Device resolution for the port's entry points.

Entry points take ``device="cuda"`` by default.  A host without a card
raises here rather than silently computing on the CPU; the CPU is used
only when the caller names it.  The reference computes in float32, so
TF32 is switched off for matrix products and cuDNN wherever the port
resolves a device.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """→ ``torch.device`` for ``device``; raises if it names a missing card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    # float32 reference arithmetic: no TF32 in matmuls or convolutions.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev

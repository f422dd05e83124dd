"""Device resolution for the port's entry points.

Entry points take ``device="cuda"`` by default.  A host without a card
raises here rather than silently computing on the CPU; the CPU is used
only when the caller names it.  ``"meta"`` is accepted too: tensors with
shapes and dtypes and no storage, on which the dry run
(``launch/dryrun.py``) traces the card's path.  The reference computes in float32, so
TF32 is switched off for matrix products and cuDNN wherever the port
resolves a device.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device", "generator_for"]


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """→ ``torch.device`` for ``device``; raises if it names a missing card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}")
    # float32 reference arithmetic: no TF32 in matmuls or convolutions.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev


def generator_for(device: torch.device, seed: int) -> torch.Generator:
    """A ``torch.Generator`` seeded with ``seed`` for drawing onto ``device``:
    the device's own, or the CPU's for ``meta`` (which has none; a draw
    into a meta tensor consumes nothing)."""
    gen_dev = "cpu" if device.type == "meta" else device
    return torch.Generator(device=gen_dev).manual_seed(seed)

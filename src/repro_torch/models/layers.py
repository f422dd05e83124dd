"""Primitive layers: linear, norms, embeddings, rotary position encoding.

Counterpart of ``repro/models/layers.py``.  Parameters are plain dicts of
tensors; every ``init_*`` draws from an explicit ``torch.Generator`` and
returns params on the generator's device (or on ``device``: a CPU
generator draws for ``meta``), every other function is pure.
The generator's numbers differ from ``jax.random``'s: tests carry the
reference's parameters across (``repro_torch.convert.params_from_jax``).
Norms and RoPE compute in float32 and cast back, as the reference does.
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device

__all__ = [
    "init_linear",
    "linear",
    "init_norm",
    "rmsnorm",
    "layernorm",
    "apply_norm",
    "init_embedding",
    "rope_freqs",
    "apply_rope",
]


def init_linear(gen: torch.Generator, d_in: int, d_out: int, bias: bool = False,
                dtype=torch.bfloat16, scale: float | None = None, device=None):
    """Truncated-normal fan-in init (standard normal cut at ±2, times scale),
    on ``device`` (``gen``'s by default)."""
    if scale is None:
        scale = d_in ** -0.5
    dev = gen.device if device is None else device
    w = torch.empty((d_in, d_out), dtype=torch.float32, device=dev)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    p = {"w": (w * scale).to(dtype)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=dev)
    return p


def linear(p, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


def init_norm(d: int, kind: str = "rmsnorm", dtype=torch.bfloat16, device="cuda"):
    """Unit scale (and zero bias) on ``device`` (the card unless the caller
    names the CPU)."""
    device = resolve_device(device)
    p = {"scale": torch.ones((d,), dtype=dtype, device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=dtype, device=device)
    return p


def rmsnorm(p, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"].to(torch.float32)).to(x.dtype)


def layernorm(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * p["scale"].to(torch.float32) + p["bias"].to(torch.float32)
    return y.to(x.dtype)


def apply_norm(p, x: torch.Tensor, kind: str) -> torch.Tensor:
    return layernorm(p, x) if kind == "layernorm" else rmsnorm(p, x)


def init_embedding(gen: torch.Generator, vocab: int, d: int, dtype=torch.bfloat16,
                   device=None):
    e = torch.randn((vocab, d), generator=gen, dtype=torch.float32,
                    device=gen.device if device is None else device)
    return {"embedding": (e * (d ** -0.5)).to(dtype)}


def rope_freqs(positions: torch.Tensor, head_dim: int, theta: float) -> tuple:
    """→ (cos, sin) of shape ``positions.shape + (head_dim/2,)`` (float32).

    ``head_dim`` is the rotated width: the whole head, or its first
    ``ModelConfig.rotary_dim`` dims, with frequencies θ^(−i/(head_dim/2))
    over that width.  The frequency table is rounded once from float64, so
    it has the same float32 bits on every device; the angles and their
    cos/sin are float32, as in the reference.
    """
    half = head_dim // 2
    exps = -torch.arange(0, half, dtype=torch.float64, device=positions.device) / half
    freq = torch.pow(float(theta), exps).to(torch.float32)
    angles = positions.to(torch.float32)[..., None] * freq
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate pairs (split-half convention).  x: (..., S, H, head_dim).

    The tables' width sets the rotated dims: ``2 · cos.shape[-1]``, the
    first of each head; the rest pass through unchanged."""
    rot = 2 * cos.shape[-1]
    if rot < x.shape[-1]:
        return torch.cat([apply_rope(x[..., :rot], cos, sin), x[..., rot:]], dim=-1)
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    # cos/sin: (..., S, half) → broadcast over the head axis
    c = cos[..., :, None, :]
    s = sin[..., :, None, :]
    xf1, xf2 = x1.to(torch.float32), x2.to(torch.float32)
    out = torch.cat([xf1 * c - xf2 * s, xf2 * c + xf1 * s], dim=-1)
    return out.to(x.dtype)

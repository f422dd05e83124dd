"""Feed-forward blocks: SwiGLU (llama/qwen), GeGLU (gemma), GELU (whisper), relu² (minitron).

Counterpart of ``repro/models/mlp.py``.  ``jax.nn.gelu`` defaults to the
tanh approximation, so the port's GELU is ``approximate="tanh"``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import init_linear, linear

__all__ = ["init_ffn", "ffn"]


def init_ffn(gen: torch.Generator, cfg, device=None):
    dt = cfg.torch_dtype
    if cfg.activation in ("swiglu", "geglu"):
        return {
            "w_gate": init_linear(gen, cfg.d_model, cfg.d_ff, False, dt, device=device),
            "w_up": init_linear(gen, cfg.d_model, cfg.d_ff, False, dt, device=device),
            "w_down": init_linear(gen, cfg.d_ff, cfg.d_model, False, dt,
                                  scale=cfg.d_ff ** -0.5, device=device),
        }
    # non-gated MLP: gelu (whisper, biases) or relu² (nemotron/minitron)
    bias = cfg.activation == "gelu"
    return {
        "w_up": init_linear(gen, cfg.d_model, cfg.d_ff, bias, dt, device=device),
        "w_down": init_linear(gen, cfg.d_ff, cfg.d_model, bias, dt,
                              scale=cfg.d_ff ** -0.5, device=device),
    }


def ffn(params, x: torch.Tensor, cfg) -> torch.Tensor:
    if cfg.activation in ("swiglu", "geglu"):
        gate = linear(params["w_gate"], x)
        act = F.silu(gate) if cfg.activation == "swiglu" else F.gelu(gate, approximate="tanh")
        return linear(params["w_down"], act * linear(params["w_up"], x))
    h = linear(params["w_up"], x)
    if cfg.activation == "relu2":
        a = F.relu(h)
        h = a * a
    else:
        h = F.gelu(h, approximate="tanh")
    return linear(params["w_down"], h)

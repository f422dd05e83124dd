"""The paper's evaluation model: 64 → 24 → 12 → 10 tanh MLP (d = 1990).

Torch port of ``repro/models/mlp_classifier.py``.  ``init_mlp`` draws
from the same ``np.random.RandomState`` stream, so both packages start
from equal weights.  Every function accepts params with an optional
leading client axis (``w0`` of shape ``(N, 64, 24)``, ``b0`` of shape
``(N, 24)``) alongside a batch with the same leading axis; that batched
form stands in for the reference's ``vmap`` over clients.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device

__all__ = ["init_mlp", "mlp_apply", "mlp_loss", "mlp_grad", "mlp_accuracy"]


def init_mlp(sizes=(64, 24, 12, 10), seed: int = 0, dtype=torch.float32,
             device="cuda") -> dict[str, torch.Tensor]:
    """Glorot-uniform weights, zero biases → ``dict[str, Tensor]``."""
    dev = resolve_device(device)
    rng = np.random.RandomState(seed)
    params = {}
    for i, (fan_in, fan_out) in enumerate(zip(sizes[:-1], sizes[1:])):
        limit = np.sqrt(6.0 / (fan_in + fan_out))
        w = rng.uniform(-limit, limit, size=(fan_in, fan_out))
        params[f"w{i}"] = torch.from_numpy(w).to(dev, dtype)
        params[f"b{i}"] = torch.zeros((fan_out,), dtype=dtype, device=dev)
    return params


def mlp_apply(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Forward pass: tanh hidden activations, linear logits."""
    n_layers = len(params) // 2
    h = x / 16.0
    for i in range(n_layers):
        h = h @ params[f"w{i}"] + params[f"b{i}"].unsqueeze(-2)
        if i < n_layers - 1:
            h = torch.tanh(h)
    return h


def mlp_loss(params: dict, batch) -> torch.Tensor:
    """Mean softmax cross-entropy over the batch axis (per client if batched)."""
    x, y = batch
    logp = torch.log_softmax(mlp_apply(params, x), dim=-1)
    nll = -torch.gather(logp, -1, y.to(torch.int64).unsqueeze(-1)).squeeze(-1)
    return nll.mean(dim=-1)


def mlp_grad(params: dict, batch) -> dict:
    """∇ of :func:`mlp_loss` (summed over clients when batched), by autograd."""
    keys = list(params)
    leaves = [params[k].detach().requires_grad_(True) for k in keys]
    with torch.enable_grad():
        loss = mlp_loss(dict(zip(keys, leaves)), batch).sum()
        grads = torch.autograd.grad(loss, leaves)
    return dict(zip(keys, grads))


def mlp_accuracy(params: dict, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    logits = mlp_apply(params, x)
    return (torch.argmax(logits, dim=-1) == y).to(torch.float32).mean(dim=-1)

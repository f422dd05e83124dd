"""Plain SGD and heavy-ball momentum (port of ``repro/optim/sgd.py``)."""
from __future__ import annotations

import torch

from repro_torch.core.tree import tree_map

__all__ = ["sgd", "sgd_momentum"]


def sgd(lr):
    def init(params):
        return ()

    def update(grads, state, params):
        new_params = tree_map(lambda w, g: w - lr * g.to(w.dtype), params, grads)
        return new_params, state

    return init, update


def sgd_momentum(lr, beta: float = 0.9, nesterov: bool = False):
    """Momentum kept in float32; params may be bf16."""

    def init(params):
        return tree_map(lambda w: torch.zeros(w.shape, dtype=torch.float32,
                                              device=w.device), params)

    def update(grads, state, params):
        new_m = tree_map(lambda m, g: beta * m + g.to(torch.float32), state, grads)
        if nesterov:
            step = tree_map(lambda m, g: beta * m + g.to(torch.float32), new_m, grads)
        else:
            step = new_m
        new_params = tree_map(lambda w, s: (w - lr * s).to(w.dtype), params, step)
        return new_params, new_m

    return init, update

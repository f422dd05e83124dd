"""Adam / AdamW with float32 moments, params may be bf16 (port of ``repro/optim/adam.py``)."""
from __future__ import annotations

import torch

from repro_torch.core.tree import tree_leaves, tree_map

__all__ = ["adam", "adamw"]


def adam(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0):
    def init(params):
        def z(w):
            return torch.zeros(w.shape, dtype=torch.float32, device=w.device)

        device = tree_leaves(params)[0].device
        return {"m": tree_map(z, params), "v": tree_map(z, params),
                "t": torch.zeros((), dtype=torch.int32, device=device)}

    def update(grads, state, params):
        t = state["t"] + 1
        m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g.to(torch.float32),
                     state["m"], grads)
        v = tree_map(lambda v_, g: b2 * v_ + (1 - b2) * torch.square(g.to(torch.float32)),
                     state["v"], grads)
        bc1 = 1 - b1 ** t.to(torch.float32)
        bc2 = 1 - b2 ** t.to(torch.float32)

        def step(w, m_, v_):
            upd = (m_ / bc1) / (torch.sqrt(v_ / bc2) + eps)
            if weight_decay:
                upd = upd + weight_decay * w.to(torch.float32)
            return (w.to(torch.float32) - lr * upd).to(w.dtype)

        new_params = tree_map(step, params, m, v)
        return new_params, {"m": m, "v": v, "t": t}

    return init, update


def adamw(lr, weight_decay: float = 0.01, **kw):
    return adam(lr, weight_decay=weight_decay, **kw)

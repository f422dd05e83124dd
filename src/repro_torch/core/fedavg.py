"""FedAvg baseline (McMahan et al., 2017), torch port of ``repro/core/fedavg.py``.

The same client stage as FedScalar (S local SGD steps), but each client
uploads its full d-dimensional update δₙ and the server averages them.
Upload cost: d × 32 bits per client per round.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.core.fedscalar import make_local_sgd
from repro_torch.core.projection import tree_size
from repro_torch.core.tree import tree_map

__all__ = ["FedAvgConfig", "fedavg_round", "upload_bits_per_client"]


@dataclasses.dataclass(frozen=True)
class FedAvgConfig:
    local_steps: int = 5
    local_lr: float = 3e-3
    server_lr: float = 1.0
    value_bits: int = 32


def fedavg_round(
    params: Any,
    client_batches: Any,   # leading axes (N, S, ...)
    round_idx,
    grad_fn: Callable,
    cfg: FedAvgConfig,
):
    """One FedAvg round over N explicit clients → ``(new_params, {})``."""
    del round_idx
    deltas = make_local_sgd(grad_fn, cfg.local_lr, cfg.local_steps)(
        params, client_batches)
    mean_delta = tree_map(lambda d: torch.mean(d.to(torch.float32), dim=0),
                          deltas)
    new_params = tree_map(lambda p, g: (p + cfg.server_lr * g).to(p.dtype),
                          params, mean_delta)
    return new_params, {}


def upload_bits_per_client(params: Any, cfg: FedAvgConfig) -> int:
    """d·32 dense frame (costmodel single source, Table I)."""
    from repro_torch.fed.costmodel import dense_upload_bits

    return dense_upload_bits(tree_size(params), cfg.value_bits)

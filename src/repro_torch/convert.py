"""Parameters between the two packages, as numpy arrays.

``params_from_jax`` takes the reference's parameters already turned into
numpy (``{k: np.asarray(v) for k, v in jax_params.items()}``) and returns
the port's ``dict[str, Tensor]`` with the same keys, shapes and dtypes;
leaf order then agrees by construction, because both packages walk dict
keys in sorted order.  ``params_to_numpy`` is the inverse.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core.tree import tree_map
from repro_torch.device import resolve_device

__all__ = ["params_from_jax", "params_to_numpy"]


def params_from_jax(np_params: Any, device="cuda") -> Any:
    """numpy tree → tensor tree on ``device`` (same keys, shapes, dtypes)."""
    dev = resolve_device(device)
    return tree_map(lambda a: torch.from_numpy(np.array(a, copy=True)).to(dev),
                    np_params)


def params_to_numpy(params: Any) -> Any:
    """tensor tree → numpy tree (same keys, shapes, dtypes)."""
    return tree_map(lambda t: t.detach().cpu().numpy(), params)

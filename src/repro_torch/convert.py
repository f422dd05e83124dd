"""Parameters between the two packages, as numpy arrays.

``params_from_jax`` takes the reference's parameters already turned into
numpy (``jax.tree_util.tree_map(np.asarray, jax_params)``: nested dicts
and lists, such as the LM tree with its ``period`` list of stacked
leaves) and returns the port's tree of tensors with the same keys,
shapes and dtypes; leaf order then agrees by construction, because both
packages walk dict keys in sorted order and lists in order.
``params_to_numpy`` is the inverse.

``np.asarray`` of a bf16 ``jax.Array`` is an ``ml_dtypes.bfloat16``
array, which ``torch.from_numpy`` rejects; such a leaf is read as its
16-bit words and reinterpreted as ``torch.bfloat16``, bit for bit,
without importing ``ml_dtypes`` (the card's machine has no jax).  The
other way, numpy has no bf16: ``params_to_numpy`` gives a bf16 leaf as
its 16-bit words in a ``V2`` array (what ``np.savez`` stores for an
``ml_dtypes.bfloat16`` array), which ``params_from_jax`` reads back and
``.view(ml_dtypes.bfloat16)`` turns into the reference's leaf.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core.tree import tree_map
from repro_torch.device import resolve_device

__all__ = ["params_from_jax", "params_to_numpy"]


def _tensor(a) -> torch.Tensor:
    a = np.array(a, copy=True)
    if a.dtype.name == "bfloat16" or (a.dtype.kind == "V" and a.dtype.itemsize == 2):
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _array(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.contiguous().view(torch.int16).numpy().view("V2")
    return t.numpy()


def params_from_jax(np_params: Any, device="cuda") -> Any:
    """numpy tree → tensor tree on ``device`` (same keys, shapes, dtypes)."""
    dev = resolve_device(device)
    return tree_map(lambda a: _tensor(a).to(dev), np_params)


def params_to_numpy(params: Any) -> Any:
    """tensor tree → numpy tree (same keys and shapes; bf16 as ``V2`` words)."""
    return tree_map(_array, params)

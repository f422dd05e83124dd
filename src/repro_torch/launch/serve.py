"""Serving steps: batched prefill + single-token greedy decode.

Counterpart of ``repro/launch/serve.py``.  FedScalar is a training
protocol; serving exercises the trained global model.
``make_prefill_step`` is the full-prompt pass that builds the KV caches
and picks the first token; ``make_decode_step`` is the one-token step
(greedy next token included).  PyTorch runs eagerly, so the steps are
plain closures, not jitted programs; the decode step updates the caches
in place and returns them.  On parameters resident on a mesh
(``models/api.py``: the reference's zero3 and tp serve layouts) the
caches are each data row's (``MeshCaches``) and the tokens come back in
batch order.
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["make_prefill_step", "make_decode_step"]


def make_prefill_step(arch, capacity: int, window: Optional[int] = None):
    def prefill_step(params, batch):
        logits, caches = arch.prefill(params, batch, capacity=capacity,
                                      window=window)
        next_token = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return next_token, caches

    return prefill_step


def make_decode_step(arch, window: Optional[int] = None):
    def decode_step(params, token, caches, position):
        logits, caches = arch.decode(params, token, caches, position,
                                     window=window)
        next_token = torch.argmax(logits[:, -1], dim=-1, keepdim=True).to(torch.int32)
        return next_token, caches

    return decode_step

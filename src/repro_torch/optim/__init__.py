"""Optimizers (no optax dependency): SGD, momentum, Adam(W), schedules.

Port of ``repro/optim``.  The FedScalar client stage uses plain SGD
(Algorithm 1 line 19); the centralized-baseline example and beyond-paper
ablations use Adam.  All optimizers are ``(init, update)`` pairs over
tensor trees (nested dicts and lists, walked as ``core/tree.py`` walks
them); ``update(grads, state, params) → (new_params, new_state)`` is pure.
"""
from repro_torch.optim.adam import adam, adamw
from repro_torch.optim.schedule import constant, cosine_decay, warmup_cosine
from repro_torch.optim.sgd import sgd, sgd_momentum

__all__ = ["sgd", "sgd_momentum", "adam", "adamw",
           "constant", "cosine_decay", "warmup_cosine"]

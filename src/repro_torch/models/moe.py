"""Mixture-of-Experts FFN with GShard-style capacity-based dispatch.

Counterpart of ``repro/models/moe.py``, step for step.  Top-k routing
(qwen3 / jamba style: softmax over the selected k logits), a fixed
per-expert capacity C = min(T, max(1, round(T·k/E·capacity_factor)))
(Python's ``round``, half to even, as in the reference), overflow tokens
dropped (their FFN contribution is zero — the residual passes through).

Dispatch is scatter/gather based, sized (E, C, d):

    1. router logits (T, E) in float32 → top-k experts (ties to the lower
       expert index, as ``jax.lax.top_k``) + probs normalised over k
    2. position-in-expert via a cumsum over the (T·k, E) one-hot, token
       major and choice minor: that order decides which tokens overflow
    3. gather tokens into the (E, C, d) expert buffer
    4. grouped products (E,C,d)·(E,d,f) → SwiGLU → (E,C,f)·(E,f,d)
    5. gather back to (T, k, d), weighted by the router prob in float32,
       summed over k

The reference has no Pallas kernel here: its expert products are plain
einsums, so the port's are ``torch.einsum`` (batched matmuls).  Kept
(expert, slot) pairs are unique, so step 3 is a plain write (dropped
pairs go to a spare slot that the products never see) and is exact and
deterministic on the card.

A batch split into groups that run one after the other (the mesh train
step's data groups, ``launch/train.py``) keeps the whole batch's
dispatch through a :class:`BatchDispatch`: C is the whole batch's, and
each group's positions start after the pairs that the groups before it
routed to each expert at the same layer (the order is token major, so
nothing after a group moves its slots).  Each group then keeps and drops
the same pairs as one call over the whole batch, and each kept token
sits at the same slot of an (E, C, d) buffer.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import init_linear

__all__ = ["init_moe", "moe_ffn", "BatchDispatch"]


class BatchDispatch:
    """The whole batch's capacity dispatch for a batch split into ``groups``
    equal groups run in order: group ``g``'s MoE layers take
    ``dispatch=(this, g, layer key)``.  Each group's per-expert counts are
    kept per layer key on its first (forward) call, so a checkpoint's
    recompute finds the same offsets."""

    def __init__(self, groups: int):
        self.groups = groups
        self._counts: dict = {}

    def offsets(self, g: int, key, counts: torch.Tensor) -> torch.Tensor:
        """→ the pairs that the groups before ``g`` routed to each expert at
        layer ``key`` (``counts``: group ``g``'s, (E,) int64)."""
        rec = self._counts.setdefault(key, [None] * self.groups)
        if rec[g] is None:
            rec[g] = counts.detach()
        if any(c is None for c in rec[:g]):
            raise RuntimeError(f"MoE layer {key}: group {g} ran before the groups "
                               "ahead of it in the batch")
        out = torch.zeros_like(counts)
        for c in rec[:g]:
            out = out + c.to(counts.device)
        return out


def init_moe(gen: torch.Generator, cfg, device=None):
    dt = cfg.torch_dtype
    e, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff
    dev = gen.device if device is None else device

    def expert_mat(shape, scale):
        w = torch.empty(shape, dtype=torch.float32, device=dev)
        torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
        return w.mul_(scale).to(dt)

    return {
        "router": init_linear(gen, d, e, False, torch.float32, device=dev),  # fp32
        "w_gate": expert_mat((e, d, f), d ** -0.5),
        "w_up": expert_mat((e, d, f), d ** -0.5),
        "w_down": expert_mat((e, f, d), f ** -0.5),
    }


def _route(logits: torch.Tensor, k: int):
    """Top-k of each row → (values, indices), ties to the lower index.

    ``jax.lax.top_k`` keeps the lower index on a tie; ``torch.topk``
    promises no order on the card.  A stable descending sort keeps equal
    logits in index order.
    """
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_ffn(params, x: torch.Tensor, cfg, dropless: bool = False, dispatch=None):
    """x: (B, S, d) → (B, S, d), plus aux dict with load-balance stats.

    ``dropless=True`` sets capacity = T (no token ever dropped) — used
    for decode steps, where T is small and quality matters per token.
    ``dispatch=(BatchDispatch, group, layer key)``: ``x`` is that group of a
    batch split in equal groups, dispatched as the whole batch would be.
    """
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    t = b * s
    xt = x.reshape(t, d)

    logits = xt.to(torch.float32) @ params["router"]["w"]            # (T, E)
    topv, topi = _route(logits, k)                                    # (T, k)
    probs = torch.softmax(topv, dim=-1)                               # normalize over k

    total = t if dispatch is None else t * dispatch[0].groups
    if dropless:
        capacity = total
    else:
        capacity = int(min(total, max(1, round(total * k / e * cfg.capacity_factor))))

    # position of each (token, choice) within its expert's capacity buffer
    onehot = F.one_hot(topi, e)                                       # (T, k, E)
    flat = onehot.reshape(t * k, e)
    # The cumsum over T·k runs along the innermost axis of the transposed
    # copy: along dim 0 of (T·k, E), CUDA scans with one thread a column.
    pos_in_expert = torch.cumsum(flat.t().contiguous(), dim=1).t() - flat  # (T·k, E)
    if dispatch is not None:           # after the earlier groups' pairs
        batch, g, key = dispatch
        pos_in_expert = pos_in_expert + batch.offsets(g, key, flat.sum(dim=0))
    pos = torch.sum(flat * pos_in_expert, dim=-1).reshape(t, k)       # (T, k)
    keep = pos < capacity                                             # overflow drop

    # ---- gather tokens into the (E, C, d) buffer ----
    # Kept (expert, slot) pairs are unique, so a plain write places each
    # kept token.  The reference adds each dropped pair as an exact zero
    # at (0, 0); a scatter-add there serialises every drop on one row, so
    # here a dropped pair writes into a spare slot C of its expert, which
    # is cut off before the products.  The buffer is the same.
    safe_e = torch.where(keep, topi, 0)
    safe_p = torch.where(keep, pos, 0)
    buf = torch.zeros((e, capacity + 1, d), dtype=x.dtype, device=x.device)
    buf = buf.index_put((topi, torch.where(keep, pos, capacity)),
                        xt[:, None, :].expand(t, k, d))[:, :capacity]  # (E, C, d)

    # ---- grouped expert computation ----
    gate = torch.einsum("ecd,edf->ecf", buf, params["w_gate"])
    up = torch.einsum("ecd,edf->ecf", buf, params["w_up"])
    act = F.silu(gate.to(torch.float32)).to(x.dtype) * up
    out_buf = torch.einsum("ecf,efd->ecd", act, params["w_down"])    # (E, C, d)

    # ---- gather back, weighted by router probability ----
    gathered = out_buf[safe_e, safe_p]                                # (T, k, d)
    weighted = gathered.to(torch.float32) * torch.where(keep, probs, 0.0)[..., None]
    yt = torch.sum(weighted, dim=1).to(x.dtype)                       # (T, d)

    # load-balance aux (Switch-style): mean prob × mean assignment per expert
    me = torch.mean(torch.softmax(logits, dim=-1), dim=0)             # (E,)
    ce = torch.mean(torch.sum(onehot, dim=1).to(torch.float32), dim=0)
    aux_loss = e * torch.sum(me * ce)

    return yt.reshape(b, s, d), {
        "moe_aux_loss": aux_loss,
        "moe_dropped_frac": 1.0 - torch.mean(keep.to(torch.float32))}

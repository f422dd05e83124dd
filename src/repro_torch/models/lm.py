"""Decoder-only LM stack: dense / GQA / MoE / Mamba / hybrid.

Counterpart of ``repro/models/lm.py``.  Layers are grouped into
**periods** as in the reference (Jamba: 8 layers = 1 attention + 7
mamba, MoE every 2nd layer; dense/MoE/SSM archs: period = 1); params for
each position-in-period are stacked across periods with a leading
``(num_periods, …)`` axis, and a Python loop over periods takes the
place of ``lax.scan``.

The parameter tree keeps the reference's layout — plain nested dicts,
the ``period`` list and the stacked leading axis — because the
federated-LLM training slice projects over these leaves and the leaf
ordinal seeds every direction (``core/tree.py``): leaf order and shapes
must stay those of ``jax.tree_util.tree_leaves`` on the reference's tree.
``init_lm`` allocates each stacked leaf once and fills it period by
period, so building a model takes its parameters plus one sublayer's
draw.

Entry points: ``lm_loss`` (next-token cross-entropy over ``lm_forward``,
the training shapes), ``lm_prefill`` (forward + fill the KV and SSM
caches) and ``lm_decode`` (one token against the caches, which it
updates in place).  ``lm_forward`` runs each period under
``torch.utils.checkpoint`` by default, as the reference runs its scan
body under ``jax.checkpoint``: only period-boundary activations are kept
for the backward pass.  As in the reference, the MoE FFN runs with its
capacity limit in training and prefill and dropless at decode, and its
aux dict is discarded.  The reference's ``constrain(...)`` calls are
sharding hints for its partitioner; the port has none, so they are
dropped.

``params`` may also be a tree resident in shards (the mesh train step's
``sharding/resident.py::ResidentTree``, or anything with its
``compute_tree``): ``lm_forward``, ``lm_prefill`` and ``lm_decode`` then
read it through :func:`compute_view` on the inputs' device, which
gathers the unstacked leaves once a call and each period's weights
(under :data:`STACKED_KEYS`) inside that period's checkpoint
(:func:`remat_call`; serving gathers each period as it starts, with no
checkpoint, so one period's weights are alive at a time).  A
``ReplicaStack`` of resident replicas feeds the client-parallel forward
(``clients=True``) in the same way, each period's slices stacked.
"""
from __future__ import annotations

import functools
import math
from typing import Any, NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.tree import tree_leaves, tree_map, tree_unflatten
from repro_torch.device import resolve_device
from repro_torch.models.attention import attention, init_attention, init_cache
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    apply_norm,
    init_embedding,
    init_linear,
    init_norm,
    linear,
)
from repro_torch.models.mamba import (
    init_mamba,
    init_mamba_cache,
    mamba_block,
    mamba_decode_step,
)
from repro_torch.models.mlp import ffn, init_ffn
from repro_torch.models.moe import init_moe, moe_ffn

__all__ = [
    "period_structure",
    "init_lm",
    "lm_forward",
    "lm_loss",
    "lm_prefill",
    "lm_decode",
    "LayerCaches",
    "init_lm_caches",
    "init_stacked",
    "placer",
    "stack_slice",
    "client_map",
    "mean_nll",
    "remat_call",
    "STACKED_KEYS",
    "compute_view",
    "unstacked",
]


# ---------------------------------------------------------------------------
# structure
# ---------------------------------------------------------------------------

def period_structure(cfg: ModelConfig):
    """→ (period_len, num_periods, [(layer_kind, ffn_kind)] per position)."""
    if cfg.attn_period:
        p = cfg.attn_period
        if cfg.moe_period:
            # lcm with moe_period (jamba: lcm(8, 2) = 8)
            p = math.lcm(p, cfg.moe_period)
    else:
        p = 1
    if cfg.num_layers % p:
        raise ValueError(f"{cfg.num_layers} layers do not divide into periods of {p}")
    kinds = [(cfg.layer_kind(i), cfg.ffn_kind(i)) for i in range(p)]
    return p, cfg.num_layers // p, kinds


def _init_sublayer(gen, cfg, kind: str, ffn_kind: str, dev=None):
    dt = cfg.torch_dtype
    dev = gen.device if dev is None else dev
    p: dict[str, Any] = {"norm1": init_norm(cfg.d_model, cfg.norm, dt, dev)}
    if kind == "attn":
        p["attn"] = init_attention(gen, cfg, dev)
    else:
        p["mamba"] = init_mamba(gen, cfg, dev)
    if ffn_kind != "none":
        p["norm2"] = init_norm(cfg.d_model, cfg.norm, dt, dev)
        p["ffn"] = (init_moe(gen, cfg, dev) if ffn_kind == "moe"
                    else init_ffn(gen, cfg, dev))
    return p


def init_stacked(make, n: int):
    """``n`` trees drawn in turn by ``make()``, each written into its slice
    of stacks allocated once (the reference's ``jax.vmap`` of an init over
    n keys stacks the same way); each tree is dropped once copied."""
    stacked = None
    for i in range(n):
        sub = make()
        if stacked is None:
            stacked = tree_map(lambda w: torch.empty((n,) + tuple(w.shape),
                                                     dtype=w.dtype, device=w.device),
                               sub)
        for dst, src in zip(tree_leaves(stacked), tree_leaves(sub)):
            dst[i].copy_(src)
        del sub
    return stacked


def placer(into):
    """``put(path, make, n=None)``: with ``into`` None, ``make()`` (or with
    ``n`` the stacks of ``n`` draws, :func:`init_stacked`); with a resident
    tree, each draw written into its shards at ``path`` (each of the ``n``
    at its slice) as soon as it is made, returning None."""
    def put(path, make, n=None):
        if into is None:
            return make() if n is None else init_stacked(make, n)
        for i in (None,) if n is None else range(n):
            into.write_tree(path, make(), i)
        return None
    return put


def init_lm(cfg: ModelConfig, gen: torch.Generator, device=None, into=None):
    """Full parameter tree on ``device`` (``gen``'s by default; ``meta``
    from a CPU generator allocates nothing); per-period-position stacks.

    Draws from ``gen`` (not ``jax.random``): the numbers differ from the
    reference's, the layout does not.  Position by position, period by
    period, each sublayer in ``_init_sublayer``'s order.  With ``into`` (an
    empty :class:`~repro_torch.sharding.resident.ResidentTree` of this
    tree's shapes) the same draws are placed in its shards one sublayer
    or leaf at a time, and ``into`` is returned.
    """
    plen, nper, kinds = period_structure(cfg)
    dt = cfg.torch_dtype
    dev = gen.device if device is None else device
    put = placer(into)
    period = [put(("period", pos),
                  lambda: _init_sublayer(gen, cfg, kind, ffn_kind, dev), nper)
              for pos, (kind, ffn_kind) in enumerate(kinds)]
    params = {
        "embed": put(("embed",), lambda: init_embedding(gen, cfg.vocab_size,
                                                        cfg.d_model, dt, dev)),
        "period": period,
        "final_norm": put(("final_norm",),
                          lambda: init_norm(cfg.d_model, cfg.norm, dt, dev)),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = put(("lm_head",), lambda: init_linear(
            gen, cfg.d_model, cfg.vocab_size, False, dt, device=dev))
    if cfg.max_position and not cfg.use_rope:
        params["pos_embed"] = put(("pos_embed",), lambda: init_embedding(
            gen, cfg.max_position, cfg.d_model, dt, dev))
    return params if into is None else into


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _sublayer_fwd(sub, x, cfg, kind, ffn_kind, positions, window, prefix_len,
                  cache=None, update_cache=False, decode=False, moe_dispatch=None):
    """One (attn|mamba) + optional FFN sublayer with pre-norms + residuals
    (``moe_dispatch``: ``moe_ffn``'s ``dispatch``)."""
    new_cache = cache
    h = apply_norm(sub["norm1"], x, cfg.norm)
    if kind == "attn":
        y, new_cache = attention(
            sub["attn"], h, cfg, positions=positions, causal=True, window=window,
            prefix_len=prefix_len, cache=cache, update_cache=update_cache)
    elif decode:
        y, new_cache = mamba_decode_step(sub["mamba"], h, cfg, cache)
    elif cache is not None:
        y, new_cache = mamba_block(sub["mamba"], h, cfg, h0=cache.h,
                                   conv_hist=cache.conv)
    else:
        y, _ = mamba_block(sub["mamba"], h, cfg)
    x = x + y
    if ffn_kind != "none":
        h = apply_norm(sub["norm2"], x, cfg.norm)
        if ffn_kind == "moe":
            y, _aux = moe_ffn(sub["ffn"], h, cfg, dropless=decode,
                              dispatch=moe_dispatch)
        else:
            y = ffn(sub["ffn"], h, cfg)
        x = x + y
    return x, new_cache


def _embed_inputs(params, cfg, tokens, embeds):
    parts = []
    if embeds is not None:
        parts.append(embeds.to(cfg.torch_dtype))
    if tokens is not None:
        parts.append(params["embed"]["embedding"][tokens])
    x = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
    if cfg.max_position and not cfg.use_rope:
        s = x.shape[1]
        x = x + params["pos_embed"]["embedding"][:s][None]
    return x


def _logits(params, cfg, x):
    if cfg.tie_embeddings:
        return x.to(torch.float32) @ params["embed"]["embedding"].to(torch.float32).T
    return linear(params["lm_head"], x).to(torch.float32)


# The top-level keys whose leaves stack the periods on a leading axis.
STACKED_KEYS = ("period",)


def compute_view(params, device, stacked_keys: tuple):
    """``params``, or, for a tree resident in shards (anything with a
    ``compute_tree``, as ``sharding/resident.py::ResidentTree``), the tree
    a forward on ``device`` reads: the leaves outside ``stacked_keys``
    gathered, each stacked leaf handing out its periods' shards."""
    compute = getattr(params, "compute_tree", None)
    return params if compute is None else compute(device, stacked_keys)


def unstacked(params, stacked_keys: tuple) -> dict:
    """``params`` less its top-level ``stacked_keys``: what a stage outside
    the period loop reads (a stacked leaf of a resident tree is no tensor,
    and :func:`client_map`'s vmap takes tensors only)."""
    return {k: v for k, v in params.items() if k not in stacked_keys}


def stack_slice(tree, i: int, clients: bool = False):
    """Slice ``i`` of every stacked leaf of ``tree`` (views into the stacks):
    the i-th period's params, or the i-th layer's; with ``clients`` the
    stacks lead with a client axis, and slice ``i`` is taken behind it.  A
    leaf that is not a tensor (a resident tree's stacked leaf,
    ``sharding/resident.py::StackedLeaf``) gives its ``slice(i)``: the
    slice's shards, gathered by :func:`remat_call`; under ``clients`` only
    a stacked leaf of replicas (``ReplicaStack``'s) is taken."""
    if isinstance(tree, dict):
        return {k: stack_slice(v, i, clients) for k, v in tree.items()}
    if isinstance(tree, list):
        return [stack_slice(v, i, clients) for v in tree]
    if not isinstance(tree, torch.Tensor):
        if clients != getattr(tree, "clients", False):
            raise ValueError("the client-parallel forward takes stacked replicas "
                             "(sharding/resident.py::ReplicaStack), not one "
                             "resident tree" if clients else
                             "a stack of replicas feeds the client-parallel forward")
        return tree.slice(i)
    return tree[:, i] if clients else tree[i]


def client_map(fn, clients: bool):
    """``fn``, or with ``clients`` its ``torch.func.vmap`` over a leading
    client axis of every argument: the client-parallel train step
    (``launch/train.py``) runs each stage of the forward over its N
    stacked replicas at once, with each period's checkpoint outside the
    vmap (a checkpoint inside one would recompute outside it)."""
    return torch.func.vmap(fn) if clients else fn


def remat_call(body, params, x, remat: bool):
    """``body(params, x)``; with ``remat``, under
    ``torch.utils.checkpoint.checkpoint(use_reentrant=False)`` with the
    params' leaves passed as its inputs (in sorted-key order), so that the
    backward pass recomputes it from ``x`` (the reference's
    ``jax.checkpoint``).  The values are the same either way.

    A leaf that is not a tensor (a slice of shards,
    ``sharding/resident.py::ShardSlice``) passes its ``inputs`` (the
    shards' views) and is ``build``-gathered inside: the gathered weights
    are rebuilt in the backward pass, not kept, and each shard view gets
    its gradient."""
    nodes = tree_leaves(params)
    inputs, counts = [], []
    for node in nodes:
        ins = (node,) if isinstance(node, torch.Tensor) else node.inputs
        inputs.extend(ins)
        counts.append(len(ins))

    def run(x, *flat):
        it = iter(flat)
        built = []
        for node, c in zip(nodes, counts):
            part = [next(it) for _ in range(c)]
            built.append(part[0] if isinstance(node, torch.Tensor) else node.build(part))
        return body(tree_unflatten(params, built), x)

    if remat:
        return checkpoint(run, x, *inputs, use_reentrant=False)
    return run(x, *inputs)


def lm_forward(params, cfg: ModelConfig, tokens=None, embeds=None,
               window: Optional[int] = None, remat: bool = True,
               clients: bool = False, moe_dispatch=None):
    """Training-mode forward without caches → logits (B, S_total, V), float32.

    With ``remat`` each period runs under :func:`remat_call`'s checkpoint:
    the backward pass recomputes the period from its input activation (the
    reference's ``jax.checkpoint(period_body)``).  With ``clients`` every
    param and input leads with a client axis (N stacked replicas) and each
    stage runs under :func:`client_map` → logits (N, B, S_total, V).
    ``moe_dispatch`` ``(moe.BatchDispatch, group)``: the inputs are that
    group of a batch split in groups, whose MoE layers dispatch as the
    whole batch's would.
    """
    plen, nper, kinds = period_structure(cfg)
    params = compute_view(params, (tokens if tokens is not None else embeds).device,
                          STACKED_KEYS)
    cmap = functools.partial(client_map, clients=clients)
    top = unstacked(params, STACKED_KEYS)
    if embeds is None:
        x = cmap(lambda p, t: _embed_inputs(p, cfg, t, None))(top, tokens)
    elif tokens is None:
        x = cmap(lambda p, e: _embed_inputs(p, cfg, None, e))(top, embeds)
    else:
        x = cmap(lambda p, t, e: _embed_inputs(p, cfg, t, e))(top, tokens, embeds)
    positions = torch.arange(x.shape[-2], dtype=torch.int32, device=x.device)
    win = cfg.window if window is None else window

    def body(period_slice, x, i):
        for pos, (kind, ffn_kind) in enumerate(kinds):
            x, _ = _sublayer_fwd(period_slice[pos], x, cfg, kind, ffn_kind,
                                 positions, win, cfg.prefix_bidirectional,
                                 moe_dispatch=None if moe_dispatch is None
                                 else (*moe_dispatch, (i, pos)))
        return x

    for i in range(nper):
        x = remat_call(cmap(functools.partial(body, i=i)),
                       stack_slice(params["period"], i, clients), x, remat)
    x = cmap(lambda p, x: apply_norm(p, x, cfg.norm))(params["final_norm"], x)
    return cmap(lambda p, x: _logits(p, cfg, x))(top, x)


def lm_loss(params, cfg: ModelConfig, batch, window: Optional[int] = None,
            clients: bool = False, moe_dispatch=None) -> torch.Tensor:
    """Mean next-token cross-entropy.  batch: dict(tokens, labels[, embeds]).

    Frontends prepend non-text positions, so only the trailing
    ``labels.shape[1]`` positions are scored, as in the reference.
    ``clients`` as :func:`lm_forward`'s → each client's loss, (N,);
    ``moe_dispatch`` as its.
    """
    logits = lm_forward(params, cfg, tokens=batch.get("tokens"),
                        embeds=batch.get("embeds"), window=window, clients=clients,
                        moe_dispatch=moe_dispatch)
    return client_map(mean_nll, clients)(logits, batch["labels"])


def mean_nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy of the trailing ``labels.shape[1]`` positions."""
    logits = logits[:, -labels.shape[1]:]
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.take_along_dim(logp, labels[..., None].to(torch.int64), dim=-1)
    return torch.mean(nll)


# ---------------------------------------------------------------------------
# serving: prefill + decode
# ---------------------------------------------------------------------------

class LayerCaches(NamedTuple):
    """Per period-position cache stacks (leading axis = periods)."""
    caches: tuple  # tuple over period positions; each KVCache or MambaCache stacked


def init_lm_caches(cfg: ModelConfig, batch: int, capacity: int, device="cuda"):
    """Empty caches on ``device``, stacked over periods per period-position."""
    device = resolve_device(device)
    plen, nper, kinds = period_structure(cfg)
    out = []
    for kind, _ in kinds:
        if kind == "attn":
            single = init_cache(cfg, batch, capacity, device=device)
        else:
            single = init_mamba_cache(cfg, batch, device=device)
        out.append(type(single)(*(t[None].repeat((nper,) + (1,) * t.dim())
                                  for t in single)))
    return LayerCaches(caches=tuple(out))


def _scan_with_caches(params, cfg, x, caches, positions, window, prefix_len,
                      decode, moe_dispatch=None):
    """Run every period, writing each layer's cache slice in place (the KV
    ring's k, v and pos by the attention itself, its idx and the Mamba
    state here).  A resident tree's period is gathered as the period
    starts (:func:`remat_call` with no checkpoint) and dropped after it;
    ``moe_dispatch``: as :func:`lm_forward`'s."""
    plen, nper, kinds = period_structure(cfg)

    def body(period_slice, x, i):
        for pos, (kind, ffn_kind) in enumerate(kinds):
            st = caches.caches[pos]
            cache = type(st)(*(t[i] for t in st))
            x, nc = _sublayer_fwd(period_slice[pos], x, cfg, kind, ffn_kind,
                                  positions, window, prefix_len, cache=cache,
                                  update_cache=True, decode=decode,
                                  moe_dispatch=None if moe_dispatch is None
                                  else (*moe_dispatch, (i, pos)))
            if kind == "attn":
                st.idx[i] = nc.idx
            else:
                st.h[i].copy_(nc.h)
                st.conv[i].copy_(nc.conv)
        return x

    for i in range(nper):
        x = remat_call(functools.partial(body, i=i), stack_slice(params["period"], i),
                       x, remat=False)
    return x, caches


def lm_prefill(params, cfg: ModelConfig, tokens=None, embeds=None,
               capacity: Optional[int] = None, window: Optional[int] = None,
               moe_dispatch=None):
    """Process the full prompt, fill caches → (last-token logits, caches).
    ``params`` may be resident in shards (read through :func:`compute_view`
    on the inputs' device); ``moe_dispatch``: as :func:`lm_forward`'s."""
    params = compute_view(params, (tokens if tokens is not None else embeds).device,
                          STACKED_KEYS)
    x = _embed_inputs(params, cfg, tokens, embeds)
    b, s = x.shape[0], x.shape[1]
    cap = capacity or s
    win = cfg.window if window is None else window
    caches = init_lm_caches(cfg, b, cap, device=x.device)
    positions = torch.arange(s, dtype=torch.int32, device=x.device)
    x, caches = _scan_with_caches(params, cfg, x, caches, positions, win,
                                  cfg.prefix_bidirectional, decode=False,
                                  moe_dispatch=moe_dispatch)
    x = apply_norm(params["final_norm"], x[:, -1:], cfg.norm)
    return _logits(params, cfg, x), caches


def lm_decode(params, cfg: ModelConfig, token, caches, position,
              window: Optional[int] = None):
    """One decode step.  token: (B, 1) int; position: int or () tensor.

    → (logits (B, 1, V), caches).  ``caches`` is updated in place and
    returned.  ``params`` as :func:`lm_prefill`'s (the MoE layers run
    dropless, so a batch split in groups needs no dispatch).
    """
    params = compute_view(params, token.device, STACKED_KEYS)
    emb = params["embed"]["embedding"]
    x = emb[token]
    positions = torch.as_tensor(position, dtype=torch.int32,
                                device=emb.device).reshape(1)
    if cfg.max_position and not cfg.use_rope:
        x = x + params["pos_embed"]["embedding"][positions.long()][None]
    win = cfg.window if window is None else window
    x, caches = _scan_with_caches(params, cfg, x, caches, positions, win,
                                  cfg.prefix_bidirectional, decode=True)
    x = apply_norm(params["final_norm"], x, cfg.norm)
    return _logits(params, cfg, x), caches

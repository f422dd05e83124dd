"""Grouped-query attention with RoPE, sliding windows and a ring-buffer KV cache.

Counterpart of ``repro/models/attention.py``: GQA / MQA / MHA, QKV
biases, rotary over the whole head or its first ``cfg.rotary_dim`` dims
(the port's own ``partial_rotary_factor``), sliding windows, the
prefix-bidirectional mask (PaliGemma), the ring-buffer cache and
cross-attention (the Whisper decoder over its encoder's states).

``_sdpa`` is plain PyTorch.  ``_sdpa_blocked`` — taken, as in the
reference, for prompts and caches longer than ``BLOCKED_SDPA_THRESHOLD``
— is the hand-written flash-attention kernel on a CUDA tensor and its
plain version on a CPU tensor; under autograd on the card, and where a
query lies inside the prefix (a prefill with a prefix), it is the
reference's blocked recurrence in plain torch (``_sdpa_blocked_plain``).
A decode step past the prefix has the causal mask, and takes the kernel.
Cross-attention takes ``_sdpa``, as in the reference.

Training in float32 on the card is the exception to both: a call that
autograd records (``_flash_train_route``: a CUDA or meta tensor, float32,
q, k or v requiring grad, a head_dim the kernels take, no query inside
the prefix) takes ``kernels.flash_attention.FlashAttentionF32``, the
float32 flash kernel forward and its hand-written backward, whatever its
length, so that no (S, T) score tensor is kept or recomputed.  bf16
training, calls without grad and prefix prefills keep their routes.  The
counters ``attn.grad_calls`` (every call autograd records on the card or
meta) and ``flash_train.calls`` (those that took the flash route) say
how often it engages.

The KV cache is a fixed-capacity ring buffer: ``pos`` records each
slot's absolute token position (−1 = empty).  Unlike the reference,
whose arrays are immutable, the port writes the new tokens into the
cache's ``k``, ``v`` and ``pos`` tensors **in place** and returns a
cache holding those same tensors with ``idx`` advanced.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch import obs
from repro_torch.device import resolve_device
from repro_torch.kernels.flash_attention import (HEAD_DIMS, allowed_mask, flash_attention,
                                                 flash_attention_train)
from repro_torch.models.layers import apply_rope, init_linear, linear, rope_freqs

__all__ = ["KVCache", "init_attention", "attention", "init_cache", "NEG_INF",
           "BLOCKED_SDPA_THRESHOLD"]

NEG_INF = -1e30


class KVCache(NamedTuple):
    k: torch.Tensor          # (B, T, K, hd)
    v: torch.Tensor          # (B, T, K, hd)
    pos: torch.Tensor        # (T,) int32 absolute positions, −1 = empty
    idx: torch.Tensor        # () int32 — number of tokens seen so far


def init_attention(gen: torch.Generator, cfg, device=None):
    """Projection params (wq, wk, wv with the config's bias, wo without)."""
    hd = cfg.resolved_head_dim
    dt = cfg.torch_dtype
    kw = dict(device=device)
    return {
        "wq": init_linear(gen, cfg.d_model, cfg.num_heads * hd, cfg.qkv_bias, dt, **kw),
        "wk": init_linear(gen, cfg.d_model, cfg.num_kv_heads * hd, cfg.qkv_bias, dt,
                          **kw),
        "wv": init_linear(gen, cfg.d_model, cfg.num_kv_heads * hd, cfg.qkv_bias, dt,
                          **kw),
        "wo": init_linear(gen, cfg.num_heads * hd, cfg.d_model, False, dt, **kw),
    }


def init_cache(cfg, batch: int, capacity: int, dtype=None, device="cuda") -> KVCache:
    """Empty ring cache on ``device`` (the card unless the caller names the CPU)."""
    device = resolve_device(device)
    hd = cfg.resolved_head_dim
    dt = dtype or cfg.torch_dtype
    return KVCache(
        k=torch.zeros((batch, capacity, cfg.num_kv_heads, hd), dtype=dt, device=device),
        v=torch.zeros((batch, capacity, cfg.num_kv_heads, hd), dtype=dt, device=device),
        pos=torch.full((capacity,), -1, dtype=torch.int32, device=device),
        idx=torch.zeros((), dtype=torch.int32, device=device),
    )


def _mask_logits(scores, qpos, kpos, *, causal, window, prefix_len):
    """scores: (..., S, T); qpos: (S,), kpos: (T,) absolute positions."""
    ok = allowed_mask(qpos, kpos, causal, window)
    if causal and prefix_len:
        # the prefix attends to itself both ways
        both = (kpos[None, :] < prefix_len) & (qpos[:, None] < prefix_len)
        ok = ok | (allowed_mask(qpos, kpos, False, window) & both)
    return torch.where(ok, scores, torch.full_like(scores, NEG_INF))


def _requires_grad(x: torch.Tensor) -> bool:
    """Whether autograd tracks ``x``; inside ``torch.func.vmap`` (the
    client-parallel step) the batched wrapper does not say, its value does."""
    while torch._C._functorch.is_batchedtensor(x):
        x = torch._C._functorch.get_unwrapped(x)
    return x.requires_grad


def _grad_on_card(q, k, v) -> bool:
    """A CUDA or meta call that autograd records."""
    return ((q.is_cuda or q.is_meta) and torch.is_grad_enabled()
            and any(_requires_grad(x) for x in (q, k, v)))


def _inside_prefix(q, qpos, prefix_len) -> bool:
    """Whether a query lies inside the prefix-bidirectional span.  A
    ``meta`` tensor's positions hold no values: a call of more than one
    query counts as a prefill from position 0 (inside any prefix), a
    single query as a decode step past it, as the dry run's steps are."""
    if not prefix_len:
        return False
    if q.is_meta:
        return q.shape[1] > 1
    return int(qpos.min()) < prefix_len


def _flash_train_route(q, k, v, qpos, prefix_len) -> bool:
    """Whether the call trains through ``FlashAttentionF32``: on the card
    (or meta) under autograd, float32, a head_dim the kernels take, and no
    query inside the prefix, whose mask they do not have."""
    return (_grad_on_card(q, k, v)
            and q.dtype == k.dtype == v.dtype == torch.float32
            and q.shape[-1] in HEAD_DIMS and not _inside_prefix(q, qpos, prefix_len))


def _flash_train(q, k, v, qpos, kpos, *, causal, window, prefix_len):
    """The attention through ``FlashAttentionF32`` where
    :func:`_flash_train_route` takes the call, else None (the caller keeps
    its route); counts ``attn.grad_calls`` and ``flash_train.calls``."""
    if not _grad_on_card(q, k, v):
        return None
    obs.count("attn.grad_calls")
    if not _flash_train_route(q, k, v, qpos, prefix_len):
        return None
    obs.count("flash_train.calls")
    return flash_attention_train(q, k, v, qpos, kpos, causal=causal, window=window)


def _sdpa(q, k, v, qpos, kpos, *, causal, window, prefix_len):
    """q: (B,S,H,hd), k/v: (B,T,K,hd) → (B,S,H,hd).  fp32 softmax.

    The reference's einsums take storage-dtype operands with float32
    accumulation (``preferred_element_type``); a bf16 ``torch.einsum``
    would return bf16, so the operands are upcast to float32 first, and
    the probabilities are rounded to V's dtype before P·V as there.  At
    S = T = 8192 the score tensor is B·H·S²·4 bytes (16 GB at batch 4,
    15 heads): above the threshold the blocked path takes over.

    A float32 call that autograd records on the card takes the flash
    kernels instead (:func:`_flash_train`), which keep no score tensor;
    their sums run in another order, at float32 rounding.
    """
    out = _flash_train(q, k, v, qpos, kpos, causal=causal, window=window,
                       prefix_len=prefix_len)
    if out is not None:
        return out
    b, s, h, hd = q.shape
    t, kheads = k.shape[1], k.shape[2]
    g = h // kheads
    qg = q.reshape(b, s, kheads, g, hd)
    scale = hd ** -0.5
    scores = torch.einsum("bskgd,btkd->bkgst", qg.to(torch.float32),
                          k.to(torch.float32)) * scale
    scores = _mask_logits(scores, qpos, kpos, causal=causal, window=window,
                          prefix_len=prefix_len)
    probs = torch.softmax(scores, dim=-1)
    # P·V keeps P's (k, g, s) order and permutes the small result: with the
    # output in (s, k, g) order einsum would copy P into that order, and
    # hand its gradient back strided, which the card's softmax backward
    # copies again (the sums are the same either way)
    out = torch.einsum("bkgst,btkd->bkgsd", probs.to(v.dtype).to(torch.float32),
                       v.to(torch.float32)).permute(0, 3, 1, 2, 4)
    return out.reshape(b, s, h, hd).to(q.dtype)


# Prefill sequences (and decode caches) longer than this take the blocked
# path — the full (S, T) score tensor at 32k² would be hundreds of GiB.
BLOCKED_SDPA_THRESHOLD = 8192
# The reference's chunk sizes of its blocked recurrence.
_Q_CHUNK = 1024
_KV_CHUNK = 2048


def _sdpa_blocked_plain(q, k, v, qpos, kpos, *, causal, window, prefix_len,
                        q_chunk: int = _Q_CHUNK, kv_chunk: int = _KV_CHUNK):
    """The reference's ``_sdpa_blocked`` recurrence in plain torch.

    Query chunks × KV chunks with the online softmax (running max m,
    denominator l, accumulator acc), the reference's chunk sizes, padding
    (padded keys at position −1, padded query rows sliced off) and
    masking, so autograd reaches q, k and v.  Peak memory in the forward
    is one (q_chunk × kv_chunk) score block per head; under autograd each
    block's probabilities are kept for the backward.  Operands are upcast
    to float32 as in :func:`_sdpa`, and the probabilities rounded to V's
    dtype before P·V, as in the reference.
    """
    b, s, h, hd = q.shape
    t, kheads = k.shape[1], k.shape[2]
    g = h // kheads
    scale = hd ** -0.5
    qc, kc = min(q_chunk, s), min(kv_chunk, t)
    ps, pt = (-s) % qc, (-t) % kc
    if ps:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, ps))
        qpos = torch.nn.functional.pad(qpos, (0, ps))
    if pt:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pt))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pt))
        kpos = torch.nn.functional.pad(kpos, (0, pt), value=-1)
    nq, nk = (s + ps) // qc, (t + pt) // kc
    outs = []
    for qi in range(nq):
        qblk = q[:, qi * qc:(qi + 1) * qc].reshape(b, qc, kheads, g, hd)
        qblk = qblk.to(torch.float32)
        qp = qpos[qi * qc:(qi + 1) * qc]
        acc = torch.zeros((b, kheads, g, qc, hd), dtype=torch.float32, device=q.device)
        m = torch.full((b, kheads, g, qc), -torch.inf, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((b, kheads, g, qc), dtype=torch.float32, device=q.device)
        for ki in range(nk):
            kblk = k[:, ki * kc:(ki + 1) * kc]
            vblk = v[:, ki * kc:(ki + 1) * kc]
            kp = kpos[ki * kc:(ki + 1) * kc]
            sc = torch.einsum("bqkgd,btkd->bkgqt", qblk,
                              kblk.to(torch.float32)) * scale
            sc = _mask_logits(sc, qp, kp, causal=causal, window=window,
                              prefix_len=prefix_len)
            m_new = torch.maximum(m, sc.amax(dim=-1))
            p = torch.exp(sc - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            pv = torch.einsum("bkgqt,btkd->bkgqd",
                              p.to(vblk.dtype).to(torch.float32),
                              vblk.to(torch.float32))
            acc = acc * corr[..., None] + pv
            m = m_new
        out = acc / torch.clamp(l[..., None], min=1e-30)       # (B,K,G,qc,hd)
        outs.append(out.permute(0, 3, 1, 2, 4))                 # (B,qc,K,G,hd)
    out = torch.cat(outs, dim=1).reshape(b, s + ps, h, hd)
    return out[:, :s].to(q.dtype)


def _sdpa_blocked(q, k, v, qpos, kpos, *, causal, window, prefix_len):
    """Attention over more than ``BLOCKED_SDPA_THRESHOLD`` tokens.

    The reference's ``_sdpa_blocked`` is the pure-JAX online softmax over
    query and KV chunks.  Here the flash-attention kernels take it
    (``kernels.flash_attention``: the hand-written kernel on a CUDA
    tensor, its plain version on a CPU tensor), and under autograd in
    float32 on the card the kernels forward and backward
    (:func:`_flash_train`), except where they cannot: where a query lies
    inside the prefix-bidirectional span, whose mask they do not have, and
    on the card under autograd in bf16, where they have no backward.  Those
    take :func:`_sdpa_blocked_plain`, the reference's recurrence itself.
    When every query lies at or past the prefix (a decode step), the
    prefix term of the mask is empty and the mask is the causal one, which
    the kernels take.

    A ``meta`` tensor (the dry run) takes the card's branches
    (:func:`_inside_prefix` says how it counts the prefix).
    """
    out = _flash_train(q, k, v, qpos, kpos, causal=causal, window=window,
                       prefix_len=prefix_len)
    if out is not None:
        return out
    if _inside_prefix(q, qpos, prefix_len) or _grad_on_card(q, k, v):
        return _sdpa_blocked_plain(q, k, v, qpos, kpos, causal=causal,
                                   window=window, prefix_len=prefix_len)
    return flash_attention(q, k, v, qpos.to(torch.int32).contiguous(),
                           kpos.to(torch.int32).contiguous(), causal=causal,
                           window=window)


def attention(
    params,
    x: torch.Tensor,                          # (B, S, D)
    cfg,
    *,
    positions: Optional[torch.Tensor] = None,  # (S,) absolute positions
    causal: bool = True,
    window: int = 0,
    prefix_len: int = 0,
    cache: Optional[KVCache] = None,
    update_cache: bool = False,
    encoder_states: Optional[torch.Tensor] = None,  # cross-attention source
):
    """One attention layer.  Returns ``(y, cache)``.

    Modes:
      * train/encoder:   cache=None                      (self-attn over x)
      * prefill:         cache=empty, update_cache=True  (fills ring buffer)
      * decode:          cache=filled, update_cache=True (S=1 append)
      * cross-attention: encoder_states given            (keys from encoder)

    With ``update_cache`` the new tokens are written into ``cache``'s
    tensors in place; the returned cache shares them and has ``idx + S``.
    """
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32, device=x.device)

    q = linear(params["wq"], x).reshape(b, s, cfg.num_heads, hd)

    if encoder_states is not None:
        # Cross-attention: K/V from the encoder, no RoPE, causality or cache.
        t = encoder_states.shape[1]
        k = linear(params["wk"], encoder_states).reshape(b, t, cfg.num_kv_heads, hd)
        v = linear(params["wv"], encoder_states).reshape(b, t, cfg.num_kv_heads, hd)
        kpos = torch.arange(t, dtype=torch.int32, device=x.device)
        out = _sdpa(q, k, v, positions, kpos, causal=False, window=0, prefix_len=0)
        return linear(params["wo"], out.reshape(b, s, -1)), cache

    k = linear(params["wk"], x).reshape(b, s, cfg.num_kv_heads, hd)
    v = linear(params["wv"], x).reshape(b, s, cfg.num_kv_heads, hd)

    if cfg.use_rope:
        cos, sin = rope_freqs(positions, cfg.rotary_dim, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)

    sdpa = _sdpa_blocked if s > BLOCKED_SDPA_THRESHOLD else _sdpa

    if cache is None:
        out = sdpa(q, k, v, positions, positions, causal=causal, window=window,
                   prefix_len=prefix_len)
        return linear(params["wo"], out.reshape(b, s, -1)), None

    capacity = cache.k.shape[1]
    if update_cache:
        # Ring-buffer append of the s new tokens (s=1 decode, s=S prefill).
        # If the prompt exceeds the ring (windowed cache), only the last
        # `capacity` tokens survive — write exactly those, so no slot is
        # written twice.
        if s > capacity:
            k_w, v_w = k[:, s - capacity:], v[:, s - capacity:]
            pos_w = positions[s - capacity:]
            offs = torch.arange(s - capacity, s, dtype=torch.int64, device=x.device)
        else:
            k_w, v_w, pos_w = k, v, positions
            offs = torch.arange(s, dtype=torch.int64, device=x.device)
        slots = (cache.idx.to(torch.int64) + offs) % capacity
        cache.k.index_copy_(1, slots, k_w.to(cache.k.dtype))
        cache.v.index_copy_(1, slots, v_w.to(cache.v.dtype))
        cache.pos.index_copy_(0, slots, pos_w.to(torch.int32))
        cache = KVCache(cache.k, cache.v, cache.pos, cache.idx + s)

    if s > 1:
        # Prefill: attend over the full prompt's local K/V (the ring cache
        # may hold only the trailing window — middle queries must still
        # see their own context).  The cache is read only at decode.
        out = sdpa(q, k, v, positions, positions, causal=causal,
                   window=window, prefix_len=prefix_len)
    else:
        # Decode: the blocked path for long caches keeps the float32 score
        # working set at one key tile instead of the whole cache.
        dec_sdpa = (_sdpa_blocked if cache.k.shape[1] > BLOCKED_SDPA_THRESHOLD
                    else _sdpa)
        out = dec_sdpa(q, cache.k, cache.v, positions, cache.pos, causal=causal,
                       window=window, prefix_len=prefix_len)
    return linear(params["wo"], out.reshape(b, s, -1)), cache

"""Whisper-style encoder-decoder backbone (audio frontend stubbed).

Counterpart of ``repro/models/encdec.py``.  As there, the mel-spectrogram
and conv feature extractor are a stub: the model consumes precomputed
frame embeddings ``(B, T_frames, d_model)`` (Whisper-tiny: T_frames =
1500 after the conv stack's 2× downsampling of 3000 mel frames).

Encoder: non-causal self-attention + GELU FFN, LayerNorm, sinusoidal
positions.  Decoder: causal self-attention + cross-attention over the
encoder output + GELU FFN, learned positions taken mod the table's
length.  The parameter tree keeps the reference's keys and its stacked
leading layer axis (its ``jax.vmap`` init), so
``convert.params_from_jax`` carries the reference's parameters across
unchanged; a Python loop over the layers takes the place of
``lax.scan``.  Under :func:`encdec_loss` each encoder and decoder layer
runs under ``torch.utils.checkpoint`` (the reference's
``jax.checkpoint``), as ``models/lm.py`` runs its periods.

The decoder's KV caches are updated in place, like the port's
``KVCache``.  Cross-attention K/V are recomputed from the encoder states
at every decode step, as in the reference (no cross-K/V cache).  The
reference's ``constrain(...)`` calls are sharding hints for its
partitioner, and are dropped.  :func:`encode` and :func:`encdec_loss`
also take a resident tree (the mesh train step's), as ``lm.lm_forward``
does: the unstacked leaves gathered once, each layer's weights (under
:data:`STACKED_KEYS`) inside its checkpoint; so do :func:`encdec_prefill`
and :func:`encdec_decode`, each decoder layer gathered as it starts.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional

import torch

from repro_torch.core.tree import tree_leaves
from repro_torch.models.attention import KVCache, attention, init_attention, init_cache
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import apply_norm, init_embedding, init_norm
from repro_torch.models.lm import (
    client_map,
    compute_view,
    mean_nll,
    placer,
    remat_call,
    stack_slice,
    unstacked,
)
from repro_torch.models.mlp import ffn, init_ffn

__all__ = [
    "init_encdec",
    "encode",
    "encdec_loss",
    "encdec_prefill",
    "encdec_decode",
    "init_decoder_caches",
    "DecCaches",
    "STACKED_KEYS",
]

# The top-level keys whose leaves stack the layers on a leading axis.
STACKED_KEYS = ("enc_layers", "dec_layers")


def _sinusoid(length: int, d: int, device=None) -> torch.Tensor:
    """(length, d) float32: sin then cos of pos·10000^(-i/(d/2 − 1)), in the
    reference's float32 op order."""
    pos = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    step = torch.tensor(math.log(10000.0), dtype=torch.float32, device=device) / (d // 2 - 1)
    inv = torch.exp(-dim * step)
    ang = pos * inv
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _init_enc_layer(gen, cfg, dev):
    dt = cfg.torch_dtype
    return {
        "norm1": init_norm(cfg.d_model, cfg.norm, dt, dev),
        "attn": init_attention(gen, cfg, dev),
        "norm2": init_norm(cfg.d_model, cfg.norm, dt, dev),
        "ffn": init_ffn(gen, cfg, dev),
    }


def _init_dec_layer(gen, cfg, dev):
    dt = cfg.torch_dtype
    return {
        "norm1": init_norm(cfg.d_model, cfg.norm, dt, dev),
        "self_attn": init_attention(gen, cfg, dev),
        "norm_x": init_norm(cfg.d_model, cfg.norm, dt, dev),
        "cross_attn": init_attention(gen, cfg, dev),
        "norm2": init_norm(cfg.d_model, cfg.norm, dt, dev),
        "ffn": init_ffn(gen, cfg, dev),
    }


def init_encdec(cfg: ModelConfig, gen: torch.Generator, device=None, into=None):
    """Full parameter tree on ``device`` (``gen``'s by default), each stack
    of layers with a leading layer axis.  Draws from ``gen`` (not
    ``jax.random``): the numbers differ from the reference's, the layout
    does not.  ``into``: as ``lm.init_lm``'s."""
    dt = cfg.torch_dtype
    dev = gen.device if device is None else device
    max_pos = cfg.max_position or 4096
    put = placer(into)
    params = {
        "enc_layers": put(("enc_layers",), lambda: _init_enc_layer(gen, cfg, dev),
                          cfg.encoder_layers),
        "enc_norm": put(("enc_norm",), lambda: init_norm(cfg.d_model, cfg.norm, dt, dev)),
        "dec_layers": put(("dec_layers",), lambda: _init_dec_layer(gen, cfg, dev),
                          cfg.num_layers),
        "dec_norm": put(("dec_norm",), lambda: init_norm(cfg.d_model, cfg.norm, dt, dev)),
        "embed": put(("embed",), lambda: init_embedding(gen, cfg.vocab_size,
                                                        cfg.d_model, dt, dev)),
        "pos_embed": put(("pos_embed",), lambda: init_embedding(gen, max_pos,
                                                                cfg.d_model, dt, dev)),
    }
    return params if into is None else into


def _layers(stack: dict, clients: bool = False):
    """Each layer's params of a stack (views; behind the client axis with
    ``clients``)."""
    n = tree_leaves(stack)[0].shape[1 if clients else 0]
    return (stack_slice(stack, i, clients) for i in range(n))


def encode(params, cfg: ModelConfig, frames: torch.Tensor, remat: bool = True,
           clients: bool = False):
    """frames: (B, T, d) stubbed conv-frontend output → encoder states
    (``clients``: as ``lm.lm_forward``'s)."""
    params = compute_view(params, frames.device, STACKED_KEYS)
    cmap = functools.partial(client_map, clients=clients)
    x = frames.to(cfg.torch_dtype)
    x = x + _sinusoid(x.shape[-2], cfg.d_model, x.device).to(x.dtype)[None]

    def body(layer, x):
        h = apply_norm(layer["norm1"], x, cfg.norm)
        y, _ = attention(layer["attn"], h, cfg, causal=False)
        x = x + y
        h = apply_norm(layer["norm2"], x, cfg.norm)
        return x + ffn(layer["ffn"], h, cfg)

    for layer in _layers(params["enc_layers"], clients):
        x = remat_call(cmap(body), layer, x, remat)
    return cmap(lambda p, x: apply_norm(p, x, cfg.norm))(params["enc_norm"], x)


def _dec_sublayer(layer, x, cfg, enc_states, positions, cache=None,
                  update_cache=False, window: int = 0):
    h = apply_norm(layer["norm1"], x, cfg.norm)
    y, cache = attention(layer["self_attn"], h, cfg, positions=positions,
                         causal=True, window=window, cache=cache,
                         update_cache=update_cache)
    x = x + y
    h = apply_norm(layer["norm_x"], x, cfg.norm)
    y, _ = attention(layer["cross_attn"], h, cfg, positions=positions,
                     encoder_states=enc_states)
    x = x + y
    h = apply_norm(layer["norm2"], x, cfg.norm)
    return x + ffn(layer["ffn"], h, cfg), cache


def _dec_embed(params, cfg, tokens, positions):
    """Token embeddings plus the learned positions, taken mod the table's
    length (the decoder-only stack slices ``[:s]`` instead)."""
    x = params["embed"]["embedding"][tokens]
    table = params["pos_embed"]["embedding"]
    return x + table[positions.long() % table.shape[0]][None]


def _logits(params, x):
    return x.to(torch.float32) @ params["embed"]["embedding"].to(torch.float32).T


def encdec_loss(params, cfg: ModelConfig, batch, window: Optional[int] = None,
                clients: bool = False):
    """batch: dict(embeds=(B,T,d) frames, tokens=(B,S), labels=(B,S)); each
    layer under checkpoint; with ``clients`` (as ``lm.lm_forward``'s) → each
    client's loss, (N,)."""
    params = compute_view(params, batch["tokens"].device, STACKED_KEYS)
    cmap = functools.partial(client_map, clients=clients)
    enc = encode(params, cfg, batch["embeds"], clients=clients)
    tokens = batch["tokens"]
    positions = torch.arange(tokens.shape[-1], dtype=torch.int32, device=tokens.device)
    top = unstacked(params, STACKED_KEYS)
    x = cmap(lambda p, t: _dec_embed(p, cfg, t, positions))(top, tokens)
    win = cfg.window if window is None else window

    def body(layer_enc, x):
        return _dec_sublayer(layer_enc["layer"], x, cfg, layer_enc["enc"], positions,
                             window=win)[0]

    for layer in _layers(params["dec_layers"], clients):
        x = remat_call(cmap(body), {"enc": enc, "layer": layer}, x, remat=True)
    x = cmap(lambda p, x: apply_norm(p, x, cfg.norm))(params["dec_norm"], x)
    logits = cmap(lambda p, x: _logits(p, x))(top, x)
    return cmap(mean_nll)(logits, batch["labels"])


class DecCaches(NamedTuple):
    self_caches: KVCache       # stacked (L, ...)
    enc_states: torch.Tensor   # (B, T_enc, d)


def init_decoder_caches(cfg: ModelConfig, batch: int, capacity: int,
                        enc_states: torch.Tensor) -> DecCaches:
    """Empty self-attention caches, stacked over the decoder layers, on
    ``enc_states``' device."""
    single = init_cache(cfg, batch, capacity, device=enc_states.device)
    stacked = KVCache(*(t[None].repeat((cfg.num_layers,) + (1,) * t.dim())
                        for t in single))
    return DecCaches(self_caches=stacked, enc_states=enc_states)


def _decoder_with_caches(params, cfg, x, caches: DecCaches, positions, window):
    """Every decoder layer, writing its cache slice in place (k, v and pos by
    the attention itself, idx here); a resident tree's layer gathered as it
    starts and dropped after it (``remat_call`` with no checkpoint)."""
    st = caches.self_caches

    def body(layer, x, i):
        cache = KVCache(*(t[i] for t in st))
        x, nc = _dec_sublayer(layer, x, cfg, caches.enc_states, positions,
                              cache=cache, update_cache=True, window=window)
        st.idx[i] = nc.idx
        return x

    for i, layer in enumerate(_layers(params["dec_layers"])):
        x = remat_call(functools.partial(body, i=i), layer, x, remat=False)
    return apply_norm(params["dec_norm"], x, cfg.norm)


def encdec_prefill(params, cfg: ModelConfig, frames, tokens,
                   capacity: Optional[int] = None, window: Optional[int] = None):
    """Encode audio + consume the decoder prompt → (last logits, caches).
    ``params`` may be resident in shards, as ``lm.lm_prefill``'s."""
    params = compute_view(params, tokens.device, STACKED_KEYS)
    enc = encode(params, cfg, frames)
    b, s = tokens.shape
    positions = torch.arange(s, dtype=torch.int32, device=tokens.device)
    x = _dec_embed(params, cfg, tokens, positions)
    caches = init_decoder_caches(cfg, b, capacity or s, enc)
    win = cfg.window if window is None else window
    x = _decoder_with_caches(params, cfg, x, caches, positions, win)
    return _logits(params, x[:, -1:]), caches


def encdec_decode(params, cfg: ModelConfig, token, caches: DecCaches, position,
                  window: Optional[int] = None):
    """One decode step.  token: (B, 1) int; position: int or () tensor.

    → (logits (B, 1, V), caches).  ``caches`` is updated in place and
    returned.  ``params`` as :func:`encdec_prefill`'s.
    """
    params = compute_view(params, token.device, STACKED_KEYS)
    emb = params["embed"]["embedding"]
    positions = torch.as_tensor(position, dtype=torch.int32, device=emb.device).reshape(1)
    x = _dec_embed(params, cfg, token, positions)
    win = cfg.window if window is None else window
    x = _decoder_with_caches(params, cfg, x, caches, positions, win)
    return _logits(params, x), caches

"""``decoder.py``'s plain float32 decoder with rotary positions over part of each
head, and one client's step of the training round through it.

A configuration file's ``partial_rotary_factor`` (1.0 when absent) sets
the rotated width rot = int(factor · head_dim): the first rot dims of each
query and key head turn in split halves at frequencies θ^(−i/(rot/2)), and
the other head_dim − rot dims pass through unchanged, as Nemotron's rotary
(hf:nvidia/Minitron-8B-Base, ``partial_rotary_factor`` 0.5).  The query
width h·hd may differ from the hidden size.  The leaves, the norms, the
MLP, the head and the loss are ``decoder.py``'s, and so is the way the
gradients are formed, a layer at a time; at a factor of 1.0 the forward
is ``decoder.py``'s.  Every matmul here is float32 with TF32 off.

With ``quant`` (the control) every matmul operand passes through it in
the forward, and the backward takes the identity: the projections'
weights and inputs, and attention's queries, keys, probabilities and
values.  :func:`quant_below` gives the precision one step below a dtype.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from fedbench.reference import decoder
from fedbench.reference.decoder import Weights, _norm, _st, head_loss
from fedbench.reference.train import _row_range, fp8_quant, project


def _no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def dims(cfg: dict) -> dict:
    m = decoder.dims(cfg)
    m["rot"] = int(float(cfg.get("partial_rotary_factor", 1.0)) * m["hd"])
    return m


def _rope(x, pos, theta: float, rot: int):
    """``decoder._rope`` over the first ``rot`` dims of each head."""
    if rot == x.shape[-1]:
        return decoder._rope(x, pos, theta)
    return torch.cat([decoder._rope(x[..., :rot], pos, theta), x[..., rot:]], dim=-1)


def layer_forward(p: dict, x: torch.Tensor, m: dict, quant=None) -> torch.Tensor:
    """One decoder layer on (T, d) float32 activations of one sequence."""
    t = x.shape[0]
    pos = torch.arange(t, device=x.device)
    h = _st(quant, _norm(x, p["norm1/scale"], p.get("norm1/bias"), m["norm"]))
    q = (h @ p["attn/wq/w"]).view(t, m["h"], m["hd"])
    k = (h @ p["attn/wk/w"]).view(t, m["kv"], m["hd"])
    v = (h @ p["attn/wv/w"]).view(t, m["kv"], m["hd"])
    q, k = _rope(q, pos, m["theta"], m["rot"]), _rope(k, pos, m["theta"], m["rot"])
    g = m["h"] // m["kv"]
    k, v = k.repeat_interleave(g, dim=1), v.repeat_interleave(g, dim=1)
    scores = torch.einsum("shd,thd->hst", _st(quant, q), _st(quant, k)) * m["hd"] ** -0.5
    causal = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
    probs = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
    att = torch.einsum("hst,thd->shd", _st(quant, probs), _st(quant, v)).reshape(t, -1)
    x = x + _st(quant, att) @ p["attn/wo/w"]
    h = _st(quant, _norm(x, p["norm2/scale"], p.get("norm2/bias"), m["norm"]))
    if m["act"] == "silu":
        a = F.silu(h @ p["ffn/w_gate/w"]) * (h @ p["ffn/w_up/w"])
    else:
        a = torch.relu(h @ p["ffn/w_up/w"]) ** 2
    return x + _st(quant, a) @ p["ffn/w_down/w"]


def grads(weights: Weights, tokens: torch.Tensor, labels: torch.Tensor, take) -> float:
    """The loss of one sequence; each leaf's gradient is handed to
    ``take(path, layer, grad)`` as it is formed (``layer`` None for an
    unstacked leaf), the stacked leaves one layer at a time from the top:
    the forward keeps each layer's input, and the backward runs each layer
    again from it under autograd."""
    _no_tf32()
    m = weights.m
    with torch.no_grad():
        top = weights.top()
        xs = [top["embed/embedding"][tokens]]
        for i in range(m["layers"]):
            xs.append(layer_forward(weights.layer(i), xs[-1], m, weights.quant))
    top = {k: v.requires_grad_(True) for k, v in top.items()}
    x = xs[-1].requires_grad_(True)
    lval = head_loss(top, x, labels, m, weights.quant)
    names = list(top)
    out = torch.autograd.grad(lval, [x] + [top[k] for k in names], allow_unused=True)
    gx = out[0]
    gtop = {k: torch.zeros_like(top[k]) if g is None else g
            for k, g in zip(names, out[1:])}
    del out
    for i in reversed(range(m["layers"])):
        p = {k: v.requires_grad_(True) for k, v in weights.layer(i).items()}
        xi = xs[i].requires_grad_(True)
        keys = list(p)
        g = torch.autograd.grad(layer_forward(p, xi, m, weights.quant),
                                [xi] + [p[k] for k in keys], gx)
        gx = g[0]
        for k, gk in zip(keys, g[1:]):
            take(f"/period/0/{k}", i, gk)
        del p, g
        xs[i + 1] = None
    emb = gtop.pop("embed/embedding").index_add(0, tokens, gx)
    take("/embed/embedding", None, emb)
    for k, gk in gtop.items():
        take("/" + k, None, gk)
    return float(lval.detach())


def client_round(tree: dict, tags: dict, m: dict, tokens, labels, lr: float,
                 seed: int, quant=None) -> tuple:
    """One client's SGD step from ``tree`` ({path: tensor} in the parameters'
    dtype), ψ = round(x − α·g) in that dtype, and its upload
    r = ⟨ψ − x, v(ξ)⟩ → (loss, r)."""
    r = 0.0

    def take(path, layer, g):
        nonlocal r
        leaf = tree[path]
        x = leaf if layer is None else leaf[layer]
        psi = (x.to(torch.float32) - lr * g).to(x.dtype)
        delta = psi.to(torch.float32) - x.to(torch.float32)
        row0, _ = _row_range(tuple(leaf.shape), layer)
        r += project(delta, seed, tags[path], row0, leaf.shape[-1])

    lval = grads(Weights(tree, m, quant), tokens, labels, take)
    return lval, r


def bf16_quant(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bfloat16, back in float32."""
    return t.to(torch.bfloat16).to(torch.float32)


def quant_below(dtype: str):
    """The cast of a matmul operand to the precision one step below
    ``dtype``: bfloat16 below float32, float8 e4m3 below bfloat16."""
    return {"float32": bf16_quant, "bfloat16": fp8_quant}[dtype]

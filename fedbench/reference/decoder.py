"""A plain float32 dense decoder with its loss and gradients, layer by layer.

The architecture from a configuration file's sizes: token embedding;
per layer a pre-norm (RMSNorm, ε 1e-6, or LayerNorm, ε 1e-5) attention
with grouped K/V heads and rotary positions (split halves, the
frequencies θ^(−i/half) rounded from float64), a pre-norm MLP (SwiGLU,
or squared ReLU with no gate), residual adds; a final norm and an
output head (the embedding's transpose when tied); the mean next-token
cross-entropy.  Everything is float32 with TF32 off.

Gradients come a layer at a time (:func:`grads`): the forward keeps
each layer's input only, and the backward runs each layer again from
its input under autograd, so an 8-billion-parameter model fits beside
its float32 copy of one layer.  The parameters are read from the
protocol's tree (:func:`protocol_leaves`: the paths and shapes whose
sorted order numbers the leaves for the seeded directions), a stacked
leaf one layer at a time.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def dims(cfg: dict) -> dict:
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    return {"d": d, "f": cfg["intermediate_size"], "h": h,
            "kv": cfg["num_key_value_heads"], "hd": cfg.get("head_dim", d // h),
            "layers": cfg["num_hidden_layers"], "vocab": cfg["vocab_size"],
            "act": cfg["hidden_act"], "norm": cfg["norm"],
            "tied": bool(cfg["tie_word_embeddings"]), "theta": float(cfg["rope_theta"])}


def protocol_leaves(cfg: dict) -> list:
    """[(path, shape)] of the model's parameters in sorted-key order: each
    per-layer matrix stacked over the layers on a leading axis."""
    m = dims(cfg)
    d, f, L = m["d"], m["f"], m["layers"]
    qd, kd = m["h"] * m["hd"], m["kv"] * m["hd"]
    norm = ["scale", "bias"] if m["norm"] == "layernorm" else ["scale"]
    ffn = {"w_up": (L, d, f), "w_down": (L, f, d)}
    if m["act"] == "silu":
        ffn["w_gate"] = (L, d, f)
    leaves = {"/embed/embedding": (m["vocab"], d)}
    leaves.update({f"/final_norm/{n}": (d,) for n in norm})
    if not m["tied"]:
        leaves["/lm_head/w"] = (d, m["vocab"])
    for name, shape in {"wq": (L, d, qd), "wk": (L, d, kd), "wv": (L, d, kd),
                        "wo": (L, qd, d)}.items():
        leaves[f"/period/0/attn/{name}/w"] = shape
    for name, shape in ffn.items():
        leaves[f"/period/0/ffn/{name}/w"] = shape
    for i in (1, 2):
        leaves.update({f"/period/0/norm{i}/{n}": (L, d) for n in norm})
    return sorted(leaves.items())


def _norm(x, w, b, kind):
    if kind == "layernorm":
        return F.layer_norm(x, (x.shape[-1],), w, b, eps=1e-5)
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + 1e-6) * w


def _rope(x, pos, theta):
    half = x.shape[-1] // 2
    freq = torch.pow(theta, -torch.arange(half, dtype=torch.float64, device=x.device)
                     / half).to(torch.float32)
    ang = pos.to(torch.float32)[:, None] * freq
    c, s = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def _st(quant, t):
    """``quant(t)`` in the forward, the identity in the backward."""
    return t if quant is None else t + (quant(t) - t).detach()


def layer_forward(p: dict, x: torch.Tensor, m: dict, quant=None) -> torch.Tensor:
    """One decoder layer on (T, d) float32 activations of one sequence;
    ``quant`` takes each matmul's activation operand (the weights come
    quantized from :class:`Weights`)."""
    t = x.shape[0]
    pos = torch.arange(t, device=x.device)
    h = _st(quant, _norm(x, p["norm1/scale"], p.get("norm1/bias"), m["norm"]))
    q = (h @ p["attn/wq/w"]).view(t, m["h"], m["hd"])
    k = (h @ p["attn/wk/w"]).view(t, m["kv"], m["hd"])
    v = (h @ p["attn/wv/w"]).view(t, m["kv"], m["hd"])
    q, k = _rope(q, pos, m["theta"]), _rope(k, pos, m["theta"])
    g = m["h"] // m["kv"]
    k, v = k.repeat_interleave(g, dim=1), v.repeat_interleave(g, dim=1)
    scores = torch.einsum("shd,thd->hst", q, k) * m["hd"] ** -0.5
    causal = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
    probs = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
    att = _st(quant, torch.einsum("hst,thd->shd", probs, v).reshape(t, -1))
    x = x + att @ p["attn/wo/w"]
    h = _st(quant, _norm(x, p["norm2/scale"], p.get("norm2/bias"), m["norm"]))
    if m["act"] == "silu":
        a = F.silu(h @ p["ffn/w_gate/w"]) * (h @ p["ffn/w_up/w"])
    else:
        a = torch.relu(h @ p["ffn/w_up/w"]) ** 2
    return x + _st(quant, a) @ p["ffn/w_down/w"]


def head_loss(top: dict, x: torch.Tensor, labels: torch.Tensor, m: dict,
              quant=None) -> torch.Tensor:
    h = _st(quant, _norm(x, top["final_norm/scale"], top.get("final_norm/bias"), m["norm"]))
    w = top["embed/embedding"].T if m["tied"] else top["lm_head/w"]
    return F.cross_entropy(h @ w, labels)


class Weights:
    """The reference's float32 view of a parameter tree given as
    {path: tensor} in the protocol's layout (any dtype, on the card);
    with ``quant`` each matrix is passed through it (norms are not)."""

    def __init__(self, tree: dict, m: dict, quant=None):
        self.tree, self.m, self.quant = tree, m, quant

    def _f32(self, key: str, w: torch.Tensor) -> torch.Tensor:
        w = w.detach().to(torch.float32)
        return w if self.quant is None or w.dim() < 2 or "norm" in key else self.quant(w)

    def layer(self, i: int) -> dict:
        pre = "/period/0/"
        return {k[len(pre):]: self._f32(k, v[i]) for k, v in self.tree.items()
                if k.startswith(pre)}

    def top(self) -> dict:
        return {k[1:]: self._f32(k, v) for k, v in self.tree.items()
                if not k.startswith("/period/")}


def loss(weights: Weights, tokens: torch.Tensor, labels: torch.Tensor) -> float:
    """The mean cross-entropy of one sequence, (T,) ids and labels."""
    with torch.no_grad():
        top = weights.top()
        x = top["embed/embedding"][tokens]
        for i in range(weights.m["layers"]):
            x = layer_forward(weights.layer(i), x, weights.m, weights.quant)
        return float(head_loss(top, x, labels, weights.m, weights.quant))


def grads(weights: Weights, tokens: torch.Tensor, labels: torch.Tensor, take) -> float:
    """The loss of one sequence; each leaf's gradient is handed to
    ``take(path, layer, grad)`` as it is formed (``layer`` None for an
    unstacked leaf), the stacked leaves one layer at a time from the top."""
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

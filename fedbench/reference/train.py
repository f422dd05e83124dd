"""Plain reference of one FedScalar training round of a language model.

Each client n of the round starts from the server's parameters x, takes
one SGD step on its own sequence with the float32 decoder's gradient
(``decoder.grads``), kept in the parameters' dtype (ψ = round(x − α·g)),
and uploads rₙ = ⟨ψ − x, v(ξₙ)⟩ with ξₙ the round's seed for client n.
The server then applies, per element,

    x ← round(x + lr · (Σₙ round(rₙ·vₙ(ξₙ))) / N)

each client's reconstruction rounded to the parameters' dtype before
the float32 sum, as the FedScalar language-model round defines its
close.  The round seeds are worked out again from the protocol's
definition (:func:`round_seeds`).

``quant`` (the control) casts every matmul operand to float8 (e4m3,
scaled per tensor to its largest magnitude) before the product.
"""
from __future__ import annotations

import torch

from fedbench.reference import decoder
from fedbench.reference.chain import M32, direction, leaf_seeds, signs

SEED_SALT = 0x5EED
ROW_CHUNK_ELEMS = 1 << 26


def round_seeds(round_idx: int, n: int) -> list:
    """ξ for clients 0 … n−1 of a round: a multiply-xor-shift of
    (round, client) with the protocol's salt, on 32-bit words."""
    out = []
    for c in range(n):
        x = ((round_idx * 0x9E3779B9) & M32) ^ ((c * 0x85EBCA6B) & M32) ^ SEED_SALT
        x ^= x >> 16
        x = (x * 0x21F0AAAD) & M32
        out.append(x ^ (x >> 15))
    return out


def view2d(shape: tuple) -> tuple:
    if len(shape) == 1:
        return 1, shape[0]
    rows = 1
    for s in shape[:-1]:
        rows *= s
    return rows, shape[-1]


def _row_range(shape: tuple, layer) -> tuple:
    """(first row, rows) of a leaf's 2-D view that ``layer``'s slice covers."""
    rows, _ = view2d(shape)
    if layer is None:
        return 0, rows
    per = rows // shape[0]
    return layer * per, per


def project(delta: torch.Tensor, seed: int, tag: int, row0: int, cols: int) -> float:
    """⟨δ, v(ξ)⟩ over rows [row0, …) of a leaf, in float64, by row chunks."""
    d2 = delta.reshape(-1, cols)
    step = max(1, ROW_CHUNK_ELEMS // cols)
    acc = 0.0
    for a in range(0, d2.shape[0], step):
        part = d2[a:a + step]
        v = direction(seed, tag, part.shape[0], cols, row0 + a, part.device)
        acc += float((part.to(torch.float64) * v).sum())
    return acc


def client_round(tree: dict, tags: dict, m: dict, tokens, labels, lr: float,
                 seed: int, quant=None) -> tuple:
    """One client's step from ``tree`` ({path: tensor} in the parameters'
    dtype) → (loss, r)."""
    r = 0.0

    def take(path, layer, g):
        nonlocal r
        leaf = tree[path]
        x = leaf if layer is None else leaf[layer]
        psi = (x.to(torch.float32) - lr * g).to(x.dtype)
        delta = psi.to(torch.float32) - x.to(torch.float32)
        row0, _ = _row_range(tuple(leaf.shape), layer)
        r += project(delta, seed, tags[path], row0, leaf.shape[-1])

    lval = decoder.grads(decoder.Weights(tree, m, quant), tokens, labels, take)
    return lval, r


def close(tree: dict, tags: dict, rs: list, seeds: list, lr: float) -> dict:
    """The server's close of the round → the new tree, leaf by leaf."""
    n = torch.tensor(float(len(rs)), dtype=torch.float32)
    out = {}
    for path, leaf in tree.items():
        rows, cols = view2d(tuple(leaf.shape))
        x2 = leaf.reshape(rows, cols)
        new = torch.empty_like(x2)
        step = max(1, ROW_CHUNK_ELEMS // cols)
        for a in range(0, rows, step):
            b = min(rows, a + step)
            acc = torch.zeros((b - a, cols), dtype=torch.float32, device=leaf.device)
            for r, s in zip(rs, seeds):
                r32 = torch.tensor(r, dtype=torch.float32).item()
                v = direction(s, tags[path], b - a, cols, a, leaf.device)
                acc += (v.to(torch.float32) * r32).to(leaf.dtype).to(torch.float32)
            new[a:b] = (x2[a:b].to(torch.float32)
                        + lr * (acc / n.to(leaf.device))).to(leaf.dtype)
        out[path] = new.reshape(leaf.shape)
    return out


def close_samples(x: torch.Tensor, tags: torch.Tensor, rows: torch.Tensor,
                  cols: torch.Tensor, rs: list, seeds: list, lr: float,
                  dtype) -> torch.Tensor:
    """:func:`close` on sampled elements alone: ``x`` (E,) float32 holding
    values of ``dtype``, located by (tag, row, col) → the new values, float32."""
    acc = torch.zeros_like(x)
    for r, s in zip(rs, seeds):
        r32 = torch.tensor(r, dtype=torch.float32).item()
        v = signs(leaf_seeds(torch.tensor([s], device=x.device), tags)[0], rows, cols)
        acc += (v.to(torch.float32) * r32).to(dtype).to(torch.float32)
    n = torch.tensor(float(len(rs)), dtype=torch.float32, device=x.device)
    return (x + lr * (acc / n)).to(dtype).to(torch.float32)


def fp8_quant(t: torch.Tensor) -> torch.Tensor:
    """``t`` through float8 e4m3 at a per-tensor scale, back in float32."""
    s = t.detach().abs().amax().clamp_min(1e-30) / 448.0
    return (t / s).to(torch.float8_e4m3fn).to(torch.float32) * s

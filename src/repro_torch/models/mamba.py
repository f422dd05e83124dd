"""Mamba-1 selective SSM block (falcon-mamba-7b, jamba mamba layers).

Counterpart of ``repro/models/mamba.py``.  The reference evaluates the
linear recurrence

    h_t = Ā_t ⊙ h_{t−1} + (Δ_t x_t) ⊗ B_t,   y_t = ⟨h_t, C_t⟩ + D x_t

as a **chunked associative scan**: an outer loop over time chunks of
``_CHUNK`` steps carries the SSM state ``h (B, d_inner, N)``, and inside
a chunk the first-order recurrence composition (a₁,b₁)∘(a₂,b₂) =
(a₁a₂, a₂b₁+b₂) is scanned in parallel.  PyTorch has no public
associative scan, so inside a chunk the port runs a log₂(chunk)-step
doubling scan (Hillis–Steele) over the chunk axis; only one chunk's
(B, chunk, d_inner, N) float32 state is ever materialised.  The
association order differs from ``lax.associative_scan``'s, which the
reference leaves open: values agree to float32 rounding.  The closed
form exp(cumsum(Δ·A)) is not used: its factors overflow.

The reference has no Pallas kernel for the scan (it is
``lax.associative_scan``), so this plain PyTorch is the port.

Decode is the exact single-step recurrence with a (B, d_inner, N)
state cache and a (B, conv−1, d_inner) rolling conv window — O(1) per
token.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.models.layers import init_linear, linear

__all__ = ["MambaCache", "init_mamba", "mamba_block", "mamba_decode_step",
           "init_mamba_cache"]

_CHUNK = 64


class MambaCache(NamedTuple):
    h: torch.Tensor      # (B, d_inner, N) SSM state (float32)
    conv: torch.Tensor   # (B, conv_width−1, d_inner) rolling conv inputs


def init_mamba(gen: torch.Generator, cfg, device=None):
    dt = cfg.torch_dtype
    dev = gen.device if device is None else device
    d, di, n = cfg.d_model, cfg.d_inner, cfg.ssm_state
    r, cw = cfg.resolved_dt_rank, cfg.ssm_conv
    in_proj = init_linear(gen, d, 2 * di, False, dt, device=dev)
    conv_w = torch.empty((cw, di), dtype=torch.float32, device=dev)
    torch.nn.init.trunc_normal_(conv_w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    x_proj = init_linear(gen, di, r + 2 * n, False, dt, device=dev)
    dt_proj = init_linear(gen, r, di, True, dt, scale=r ** -0.5, device=dev)
    out_proj = init_linear(gen, di, d, False, dt, scale=di ** -0.5, device=dev)
    # S4-style A init: A[:, j] = −(j+1) (real negative diagonal)
    a = torch.arange(1, n + 1, dtype=torch.float32, device=dev)[None, :].repeat(di, 1)
    return {
        "in_proj": in_proj,
        "conv_w": (conv_w * (cw ** -0.5)).to(dt),
        "conv_b": torch.zeros((di,), dtype=dt, device=dev),
        "x_proj": x_proj,
        "dt_proj": dt_proj,
        "a_log": torch.log(a),                     # (di, N) float32
        "d_skip": torch.ones((di,), dtype=torch.float32, device=dev),
        "out_proj": out_proj,
    }


def _ssm_params(params, xc, cfg):
    """Input-dependent Δ, B, C from the conv output xc (…, di)."""
    n, r = cfg.ssm_state, cfg.resolved_dt_rank
    proj = linear(params["x_proj"], xc)
    dt_raw, b, c = torch.split(proj, [r, n, n], dim=-1)
    delta = F.softplus(linear(params["dt_proj"], dt_raw).to(torch.float32))
    return delta, b.to(torch.float32), c.to(torch.float32)


def _causal_conv(params, x, cfg, history=None):
    """Depthwise causal conv over time.  x: (B, S, di)."""
    cw = cfg.ssm_conv
    if history is None:
        history = torch.zeros((x.shape[0], cw - 1, x.shape[2]), dtype=x.dtype,
                              device=x.device)
    xp = torch.cat([history, x], dim=1)                 # (B, S+cw−1, di)
    w = params["conv_w"].to(torch.float32)              # (cw, di)
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for j in range(cw):
        out = out + xp[:, j:j + x.shape[1]].to(torch.float32) * w[j]
    out = out + params["conv_b"].to(torch.float32)
    new_hist = xp[:, xp.shape[1] - (cw - 1):]
    return F.silu(out).to(x.dtype), new_hist


def _chunk_scan(abar, bx):
    """Inclusive scan of (a, b) pairs along dim 1 under
    (a₁,b₁)∘(a₂,b₂) = (a₁a₂, a₂b₁+b₂): log₂(chunk) doubling steps."""
    a, b = abar, bx
    c = a.shape[1]
    off = 1
    while off < c:
        b = torch.cat([b[:, :off], torch.addcmul(b[:, off:], a[:, off:], b[:, :-off])],
                      dim=1)
        if 2 * off < c:
            a = torch.cat([a[:, :off], a[:, off:] * a[:, :-off]], dim=1)
        off *= 2
    return b


def mamba_block(params, x, cfg, h0=None, conv_hist=None):
    """Full-sequence mamba block.  x: (B, S, d) → (B, S, d), final cache.

    A ragged S is padded to the chunk with Δ = 0 on the padded steps.
    """
    b, s, d = x.shape
    di, n = cfg.d_inner, cfg.ssm_state
    xz = linear(params["in_proj"], x)
    xpart, z = torch.chunk(xz, 2, dim=-1)
    xc, new_hist = _causal_conv(params, xpart, cfg, conv_hist)

    delta, bmat, cmat = _ssm_params(params, xc, cfg)    # (B,S,di),(B,S,n),(B,S,n)
    a = -torch.exp(params["a_log"])                     # (di, n)

    chunk = min(_CHUNK, s)
    pad = (-s) % chunk
    xc_s = xc.to(torch.float32)
    if pad:
        # Zero Δ on padded steps → Ā = exp(0·A) = 1, B̄x = 0: the state
        # passes through padding untouched, so the carried h stays exact.
        xc_s, delta, bmat, cmat = (
            F.pad(t, (0, 0, 0, pad)) for t in (xc_s, delta, bmat, cmat))

    h = torch.zeros((b, di, n), dtype=torch.float32, device=x.device) if h0 is None else h0
    ys = []
    for c0 in range(0, s + pad, chunk):
        xck, dk = xc_s[:, c0:c0 + chunk], delta[:, c0:c0 + chunk]
        bk, ck = bmat[:, c0:c0 + chunk], cmat[:, c0:c0 + chunk]
        abar = torch.exp(dk[..., None] * a)             # (B,chunk,di,n)
        bx = (dk * xck)[..., None] * bk[:, :, None, :]  # (B,chunk,di,n)
        # seed the scan with the carried state folded into step 0
        bx[:, 0] += abar[:, 0] * h
        hs = _chunk_scan(abar, bx)                      # (B,chunk,di,n)
        ys.append(torch.einsum("bcdn,bcn->bcd", hs, ck))  # (B,chunk,di)
        h = hs[:, -1]
    y = torch.cat(ys, dim=1)[:, :s]
    y = y + params["d_skip"] * xc.to(torch.float32)
    y = y * F.silu(z.to(torch.float32))
    out = linear(params["out_proj"], y.to(x.dtype))
    return out, MambaCache(h=h, conv=new_hist)


def init_mamba_cache(cfg, batch: int, device="cuda") -> MambaCache:
    """Empty state on ``device`` (the card unless the caller names the CPU)."""
    device = resolve_device(device)
    return MambaCache(
        h=torch.zeros((batch, cfg.d_inner, cfg.ssm_state), dtype=torch.float32,
                      device=device),
        conv=torch.zeros((batch, cfg.ssm_conv - 1, cfg.d_inner),
                         dtype=cfg.torch_dtype, device=device),
    )


def mamba_decode_step(params, x, cfg, cache: MambaCache):
    """Single-token recurrence.  x: (B, 1, d) → (B, 1, d), new cache."""
    xz = linear(params["in_proj"], x[:, 0])             # (B, 2di)
    xpart, z = torch.chunk(xz, 2, dim=-1)

    # rolling conv window
    window = torch.cat([cache.conv, xpart[:, None, :]], dim=1)  # (B,cw,di)
    w = params["conv_w"].to(torch.float32)
    xc = (torch.sum(window.to(torch.float32) * w[None], dim=1)
          + params["conv_b"].to(torch.float32))
    xc = F.silu(xc)                                     # (B, di)

    delta, bmat, cmat = _ssm_params(params, xc.to(x.dtype), cfg)
    a = -torch.exp(params["a_log"])
    abar = torch.exp(delta[..., None] * a)              # (B,di,n)
    bx = (delta * xc)[..., None] * bmat[:, None, :]     # (B,di,n)
    h = abar * cache.h + bx
    y = torch.einsum("bdn,bn->bd", h, cmat)
    y = y + params["d_skip"] * xc
    y = y * F.silu(z.to(torch.float32))
    out = linear(params["out_proj"], y.to(x.dtype))
    return out[:, None, :], MambaCache(h=h, conv=window[:, 1:])

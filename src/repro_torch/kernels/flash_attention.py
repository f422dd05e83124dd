"""Causal flash attention: the port of ``repro/kernels/flash_attention.py``,
and a float32 backward the reference does not have.

Three CUDA kernels compute it, chosen by :func:`flash_route`, a fixed
function of the shape and the dtype (each source's note gives its design
and its bound):

* ``csrc/flash_decode.cu`` (:func:`flash_decode`): split-KV, bf16 and
  float32, when S·G (query positions × query heads per kv head) is at
  most ``DECODE_MAX_ROWS`` — a decode step;
* ``csrc/flash_prefill.cu`` (:func:`flash_prefill`): bf16 on the tensor
  cores (wgmma, TMA), for every other bf16 shape — prefill;
* ``csrc/flash_attention.cu`` (:func:`flash_f32`): float32 on the CUDA
  cores, for every other float32 shape.

This module holds their plain PyTorch version and the wrapper.  All
compute ``_flash_kernel``'s function::

    out[b, s, h] = Σ_t softmax_t(q[b, s, h] · k[b, t, h // G] · hd^-0.5) · v[b, t, h // G]

over the allowed keys t: ``kpos[t] >= 0``, ``kpos[t] <= qpos[s]`` when
``causal``, and ``kpos[t] > qpos[s] - window`` when ``window`` is set;
G = H / K query heads share a kv head.  Scores, the softmax and p are
float32, and p keeps float32 precision in P·V (the prefill kernel
splits it into two bf16 halves, p_hi + p_lo, for the tensor cores;
``_sdpa_blocked`` in the reference rounds p to V's dtype, which in bf16
differs within bf16's tolerance).  The output is in q's dtype.

Layouts are the reference's: q (B, S, H, hd), k and v (B, T, K, hd),
qpos (S,) and kpos (T,) int32.  Unlike the Pallas wrapper, no multiple
of a block size is asked of S or T: the kernel masks both ragged edges.

A row with no allowed key (a padding query, say) comes out as zeros in
both versions; the Pallas kernel gives such a row a uniform average of V
over its masked keys instead.  Callers drop those rows, and at prefill
and decode every real query sees at least its own key.

Training.  :class:`FlashAttentionF32` gives float32 attention a gradient
without the (S, T) score tensor: forward, ``csrc/flash_attention.cu``
with each row's log-sum-exp (:func:`flash_attention_fwd_lse`); backward,
``csrc/flash_attention_bwd.cu`` (:func:`flash_attention_bwd`), which
recomputes P from q, k and lse.  Each has its plain version here, which
a CPU tensor takes; a ``meta`` tensor allocates the outputs and launches
nothing.  ``models/attention.py`` routes float32 calls under autograd on
the card to it; bf16 has no backward kernel, and its training keeps the
plain attention.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import obs
from repro_torch.kernels import _build
from repro_torch.kernels.common import check_cuda_tensor, raise_on_cuda_error

__all__ = ["HEAD_DIMS", "DECODE_MAX_ROWS", "decode_partition", "flash_attention",
           "flash_attention_plain", "flash_route", "flash_prefill", "flash_decode",
           "flash_f32", "allowed_mask", "flash_tile_class", "flash_compare",
           "flash_agrees", "flash_attention_fwd_lse", "flash_attention_fwd_lse_plain",
           "flash_attention_bwd", "flash_attention_bwd_plain", "FlashAttentionF32",
           "flash_attention_train"]

# head_dim values the CUDA kernels are instantiated for (256: PaliGemma).
HEAD_DIMS = (32, 64, 128, 256)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# The split-KV decode takes at most this many rows (S·G) per kv head: a
# decode step of every configuration the port serves (G ≤ 8).
DECODE_MAX_ROWS = 8

# Score elements per query chunk in the plain version (bounds its memory).
_PLAIN_SCORE_ELEMS = 1 << 26

# How far the kernel may be from its plain version, on rows with an
# allowed key.  float32: tests/test_flash_kernel.py's rtol 1e-3 / atol
# 2e-5 (sum order).  bfloat16: both versions sum in float32 and round to
# bf16 once, so an element differs by at most one bf16 ulp of the larger
# of the two, and one ulp of x is at most 2^-7·|x|: the limit is 2^-7
# times the largest |plain| of its (b, s, h) row.  Their float32 sums
# differ by ~1e-6 relative, which changes a rounding rarely; a kernel
# that rounds p to bf16 moves ~1e-3 relative and changes many, so at
# most 1% of the bf16 elements may differ at all.
F32_RTOL, F32_ATOL = 1e-3, 2e-5
BF16_ROW_ULP = 2.0 ** -7
BF16_MAX_CHANGED = 0.01


def allowed_mask(qpos: torch.Tensor, kpos: torch.Tensor, causal: bool,
                 window: int) -> torch.Tensor:
    """(S, T) bool: key t is allowed for query s."""
    q = qpos.to(torch.int64)[:, None]
    k = kpos.to(torch.int64)[None, :]
    ok = (k >= 0).expand(q.shape[0], k.shape[1])
    if causal:
        ok = ok & (k <= q)
    if window:
        ok = ok & (k > q - window)
    return ok


def flash_tile_class(qpos_rows, kpos_keys, causal: bool, window: int) -> str:
    """How ``csrc/flash_attention.cu`` treats one key tile of one row block:
    ``"skip"`` (no pair can be allowed), ``"unmasked"`` (every pair is) or
    ``"masked"``, from the block's qpos min/max over its valid rows and the
    tile's kpos min, max and min over ``kpos >= 0`` (slots past T count as
    -1), never from the tile's position: the kernel's test, written out."""
    q = [int(x) for x in qpos_rows]
    kp = [int(x) for x in kpos_keys]
    qmin, qmax = min(q), max(q)
    kmin, kmax = min(kp), max(kp)
    vmin = min((x for x in kp if x >= 0), default=2 ** 31 - 1)
    if (kmax < 0 or (causal and vmin > qmax)
            or (window and kmax <= qmin - window)):
        return "skip"
    if (kmin >= 0 and (not causal or kmax <= qmin)
            and (not window or kmin > qmax - window)):
        return "unmasked"
    return "masked"


def flash_compare(got: torch.Tensor, want: torch.Tensor):
    """→ (max |got - want|, max of |got - want| over its limit, share of
    elements that differ), ``want`` being the plain version's output."""
    g, w = got.float(), want.float()
    err = (g - w).abs()
    if want.dtype == torch.bfloat16:
        limit = BF16_ROW_ULP * w.abs().amax(dim=-1, keepdim=True)
    else:
        limit = F32_RTOL * w.abs() + F32_ATOL
    ratio = torch.where(err == 0, torch.zeros_like(err), err / limit)
    return (float(err.max()), float(ratio.max()),
            float((got != want).float().mean()))


def flash_agrees(got: torch.Tensor, want: torch.Tensor) -> bool:
    """Every element within its limit and, in bf16, at most
    ``BF16_MAX_CHANGED`` of them changed (see the limits above)."""
    _, ratio, changed = flash_compare(got, want)
    return (bool(torch.isfinite(got).all()) and ratio <= 1
            and (want.dtype != torch.bfloat16 or changed <= BF16_MAX_CHANGED))


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          qpos: torch.Tensor, kpos: torch.Tensor, *,
                          causal: bool = True, window: int = 0) -> torch.Tensor:
    """Plain version of the kernel (masked float32 softmax, query-chunked)."""
    return flash_attention_fwd_lse_plain(q, k, v, qpos, kpos, causal=causal,
                                         window=window)[0]


def flash_route(s: int, h: int, kh: int, dtype: torch.dtype) -> str:
    """Which kernel computes a call: ``"decode"`` (split-KV) when S·G is at
    most ``DECODE_MAX_ROWS``, else ``"prefill"`` (bf16, tensor cores) or
    ``"f32"`` (float32, CUDA cores)."""
    if s * (h // kh) <= DECODE_MAX_ROWS:
        return "decode"
    return "prefill" if dtype == torch.bfloat16 else "f32"


def decode_partition(hd: int, dtype: torch.dtype) -> int:
    """Keys per partition of the split-KV decode: 32 KB of K (and of V),
    256 keys at hd 64 in bf16, 64 at hd 256 (``csrc/flash_decode.cu``'s
    partition_keys)."""
    return 32768 // (hd * dtype.itemsize)


def _lib(name: str, fn: str, argtypes):
    lib = _build.library(name)
    if not getattr(lib, "_fs_typed", False):
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
        lib._fs_typed = True
    return lib


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def flash_prefill(q, k, v, qpos, kpos, out, causal: bool, window: int) -> None:
    """Launch ``csrc/flash_prefill.cu`` (bf16) into ``out``; the inputs are
    checked by :func:`flash_attention`."""
    if q.is_meta:                    # the dry run: no launch
        return
    b, s, h, hd = q.shape
    t, kh = k.shape[1], k.shape[2]
    lib = _lib("flash_prefill", "fs_flash_prefill",
               [_P] * 6 + [_I] * 6 + [_F, _I, _I, _P])
    with torch.cuda.device(q.device):
        err = lib.fs_flash_prefill(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), qpos.data_ptr(),
            kpos.data_ptr(), out.data_ptr(), b, s, h, kh, t, hd, hd ** -0.5,
            int(causal), int(window), _stream(q.device))
    raise_on_cuda_error("fs_flash_prefill", err)
    obs.count("flash_prefill.launches")


def flash_decode(q, k, v, qpos, kpos, out, causal: bool, window: int) -> None:
    """Launch ``csrc/flash_decode.cu``'s split pass and its combine into
    ``out``, with float32 scratch for the partials; the inputs are checked
    by :func:`flash_attention`."""
    b, s, h, hd = q.shape
    t, kh = k.shape[1], k.shape[2]
    part = decode_partition(hd, q.dtype)
    nparts = -(-t // part)
    rows = b * kh * s * (h // kh) * nparts
    pm = torch.empty(rows, dtype=torch.float32, device=q.device)
    pl = torch.empty(rows, dtype=torch.float32, device=q.device)
    pacc = torch.empty(rows * hd, dtype=torch.float32, device=q.device)
    if q.is_meta:                    # the dry run: the buffers, no launch
        return
    lib = _lib("flash_decode", "fs_flash_decode",
               [_P] * 9 + [_I] * 7 + [_F, _I, _I, _I, _I, _P])
    with torch.cuda.device(q.device):
        err = lib.fs_flash_decode(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), qpos.data_ptr(),
            kpos.data_ptr(), out.data_ptr(), pm.data_ptr(), pl.data_ptr(),
            pacc.data_ptr(), b, s, h, kh, t, hd, _DTYPE_CODES[q.dtype], hd ** -0.5,
            int(causal), int(window), part, nparts, _stream(q.device))
    raise_on_cuda_error("fs_flash_decode", err)
    obs.count("flash_decode.launches")


def flash_f32(q, k, v, qpos, kpos, out, causal: bool, window: int, lse=None) -> None:
    """Launch ``csrc/flash_attention.cu`` (float32) into ``out``, and each
    row's log-sum-exp into ``lse`` (B, H, S) unless it is None; the inputs
    are checked by :func:`flash_attention` or :func:`flash_attention_fwd_lse`."""
    if q.is_meta:                    # the dry run: no launch
        return
    b, s, h, hd = q.shape
    t, kh = k.shape[1], k.shape[2]
    lib = _lib("flash_attention", "fs_flash_attention",
               [_P] * 7 + [_I] * 6 + [_F, _I, _I, _P])
    with torch.cuda.device(q.device):
        err = lib.fs_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), qpos.data_ptr(),
            kpos.data_ptr(), out.data_ptr(), None if lse is None else lse.data_ptr(),
            b, s, h, kh, t, hd, hd ** -0.5, int(causal), int(window), _stream(q.device))
    raise_on_cuda_error("fs_flash_attention", err)
    obs.count("flash_f32.launches")


_KERNELS = {"prefill": flash_prefill, "decode": flash_decode, "f32": flash_f32}


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    qpos: torch.Tensor, kpos: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """→ (B, S, H, hd) in q's dtype.

    A CUDA tensor launches the kernel :func:`flash_route` names (or
    raises); a CPU tensor takes the plain version; a ``meta`` tensor (the
    dry run) takes the card's checks and allocates the kernel's output and
    scratch, launching nothing.
    The counter ``flash.launches`` (:mod:`repro_torch.obs`) counts the
    calls that launched a kernel; ``flash_prefill.launches``,
    ``flash_decode.launches`` and ``flash_f32.launches`` count each
    kernel's.
    """
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, qpos, kpos, causal=causal,
                                     window=window)
    _check_inputs(q, k, v, qpos, kpos, window, _DTYPE_CODES)
    b, s, h, hd = q.shape
    t, kh = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    if b == 0 or s == 0:
        return out
    if t == 0:
        return out.zero_()
    _KERNELS[flash_route(s, h, kh, q.dtype)](q, k, v, qpos, kpos, out, causal,
                                             window)
    if not q.is_meta:
        obs.count("flash.launches")
    return out


def _check_inputs(q, k, v, qpos, kpos, window: int, dtypes) -> None:
    """Raise on what the card's kernels do not take (device, dtype in
    ``dtypes``, layouts, shapes, head_dim, alignment)."""
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"unsupported device {q.device}")
    dev = q.device
    if q.dtype not in dtypes:
        names = " and ".join(str(d).removeprefix("torch.") for d in dtypes)
        raise TypeError(f"q has dtype {q.dtype}; the kernel takes {names}")
    check_cuda_tensor("q", q, q.dtype, 4, dev)
    check_cuda_tensor("k", k, q.dtype, 4, dev)
    check_cuda_tensor("v", v, q.dtype, 4, dev)
    check_cuda_tensor("qpos", qpos, torch.int32, 1, dev)
    check_cuda_tensor("kpos", kpos, torch.int32, 1, dev)
    b, s, h, hd = q.shape
    t, kh = k.shape[1], k.shape[2]
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != hd:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if kh == 0 or h % kh:
        raise ValueError(f"{h} query heads do not group over {kh} kv heads")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    if qpos.numel() != s or kpos.numel() != t:
        raise ValueError(f"qpos {qpos.numel()} / kpos {kpos.numel()} do not "
                         f"match S={s}, T={t}")
    if window < 0:
        raise ValueError(f"window {window} < 0")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")


# ---------------------------------------------------------------------------
# training: the float32 forward with each row's log-sum-exp, and its backward
# ---------------------------------------------------------------------------

def flash_attention_fwd_lse_plain(q, k, v, qpos, kpos, *, causal: bool = True,
                                  window: int = 0):
    """Plain version of the kernels (masked float32 softmax, query-chunked)
    with the float32 kernel's ``lse`` output → (out in q's dtype, lse):
    ``lse[b, h, s]`` = m + log l of the row's scaled, masked scores (-inf
    for a row with no allowed key, whose output is 0)."""
    b, s, h, hd = q.shape
    t, kh = k.shape[1], k.shape[2]
    g = h // kh
    scale = hd ** -0.5
    out = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    kf, vf = k.to(torch.float32), v.to(torch.float32)
    qc = max(1, _PLAIN_SCORE_ELEMS // max(b * h * t, 1))
    for s0 in range(0, s, qc):
        n = min(qc, s - s0)
        qg = q[:, s0:s0 + n].to(torch.float32).reshape(b, n, kh, g, hd)
        sc = torch.einsum("bskgd,btkd->bkgst", qg, kf) * scale
        ok = allowed_mask(qpos[s0:s0 + n], kpos, causal, window)
        sc = sc.masked_fill(~ok, float("-inf"))
        m = sc.amax(dim=-1, keepdim=True)
        m = torch.where(m == float("-inf"), torch.zeros_like(m), m)
        p = torch.exp(sc - m)
        l = p.sum(dim=-1, keepdim=True)
        o = torch.einsum("bkgst,btkd->bkgsd", p, vf)
        o = torch.where(l > 0, o / l, torch.zeros_like(o))
        out[:, s0:s0 + n] = o.permute(0, 3, 1, 2, 4).reshape(b, n, h, hd).to(q.dtype)
        row = torch.where(l > 0, m + torch.log(l), torch.full_like(l, float("-inf")))
        lse[:, :, s0:s0 + n] = row.reshape(b, h, n)
    return out, lse


def flash_attention_bwd_plain(q, k, v, out, dout, lse, qpos, kpos, *,
                              causal: bool = True, window: int = 0):
    """Plain version of ``csrc/flash_attention_bwd.cu`` → (dq, dk, dv), query
    chunk by query chunk: P = exp(s·scale - lse) over the allowed keys (0
    elsewhere, and on a row with lse = -inf), D = Σ dout·out a row,
    dS = P·(dout·vᵀ - D); dV = Pᵀ·dout, dK = scale·dSᵀ·q summed over a kv
    head's G query heads, dQ = scale·dS·k."""
    b, s, h, hd = q.shape
    t, kh = k.shape[1], k.shape[2]
    g = h // kh
    scale = hd ** -0.5
    kf, vf = k.to(torch.float32), v.to(torch.float32)
    dq = torch.empty_like(q)
    dk = torch.zeros((b, t, kh, hd), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    dsum = (dout.to(torch.float32) * out.to(torch.float32)).sum(dim=-1)   # (B, S, H)
    qc = max(1, _PLAIN_SCORE_ELEMS // max(b * h * t, 1))
    for s0 in range(0, s, qc):
        n = min(qc, s - s0)
        qg = q[:, s0:s0 + n].to(torch.float32).reshape(b, n, kh, g, hd)
        og = dout[:, s0:s0 + n].to(torch.float32).reshape(b, n, kh, g, hd)
        sc = torch.einsum("bskgd,btkd->bkgst", qg, kf) * scale
        ok = allowed_mask(qpos[s0:s0 + n], kpos, causal, window)
        row = lse[:, :, s0:s0 + n].reshape(b, kh, g, n, 1)
        p = torch.where(ok, torch.exp(sc - row), torch.zeros_like(sc))
        dp = torch.einsum("bskgd,btkd->bkgst", og, vf)
        d = dsum[:, s0:s0 + n].reshape(b, n, kh, g).permute(0, 2, 3, 1)[..., None]
        ds = p * (dp - d)
        dv += torch.einsum("bkgst,bskgd->btkd", p, og)
        dk += torch.einsum("bkgst,bskgd->btkd", ds, qg)
        dq[:, s0:s0 + n] = (torch.einsum("bkgst,btkd->bskgd", ds, kf) * scale
                            ).reshape(b, n, h, hd).to(q.dtype)
    return dq, (dk * scale).to(k.dtype), dv.to(v.dtype)


def flash_attention_fwd_lse(q, k, v, qpos, kpos, *, causal: bool = True,
                            window: int = 0):
    """→ (out (B, S, H, hd), lse (B, H, S)), float32: ``csrc/flash_attention.cu``
    with its log-sum-exp output on a CUDA tensor (or raises), the plain
    version on a CPU tensor, and on a ``meta`` tensor the outputs alone."""
    if q.device.type == "cpu":
        return flash_attention_fwd_lse_plain(q, k, v, qpos, kpos, causal=causal,
                                             window=window)
    _check_inputs(q, k, v, qpos, kpos, window, (torch.float32,))
    b, s, h, _ = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    if q.is_meta or b == 0 or s == 0:
        return out, lse
    if k.shape[1] == 0:
        return out.zero_(), lse.fill_(float("-inf"))
    flash_f32(q, k, v, qpos, kpos, out, causal, window, lse=lse)
    return out, lse


def flash_attention_bwd(q, k, v, out, dout, lse, qpos, kpos, *, causal: bool = True,
                        window: int = 0):
    """→ (dq, dk, dv), float32, the gradient of :func:`flash_attention_fwd_lse`'s
    ``out`` given ``dout``: ``csrc/flash_attention_bwd.cu`` on a CUDA tensor
    (or raises), the plain version on a CPU tensor, on a ``meta`` tensor the
    gradients and the kernel's scratch alone.  ``flash_bwd.launches``
    counts the kernel's calls."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, out, dout, lse, qpos, kpos,
                                         causal=causal, window=window)
    _check_inputs(q, k, v, qpos, kpos, window, (torch.float32,))
    check_cuda_tensor("out", out, torch.float32, 4, q.device)
    check_cuda_tensor("dout", dout, torch.float32, 4, q.device)
    check_cuda_tensor("lse", lse, torch.float32, 3, q.device)
    b, s, h, hd = q.shape
    t, kh = k.shape[1], k.shape[2]
    if out.shape != q.shape or dout.shape != q.shape or lse.shape != (b, h, s):
        raise ValueError(f"out {tuple(out.shape)} / dout {tuple(dout.shape)} / lse "
                         f"{tuple(lse.shape)} do not match q {tuple(q.shape)}")
    for name, x in (("out", out), ("dout", dout)):
        if x.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dsum = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    if q.is_meta:                    # the dry run: the buffers, no launch
        return dq, dk, dv
    if b == 0 or s == 0 or t == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    lib = _lib("flash_attention_bwd", "fs_flash_attention_bwd",
               [_P] * 12 + [_I] * 6 + [_F, _I, _I, _P])
    with torch.cuda.device(q.device):
        err = lib.fs_flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), qpos.data_ptr(), kpos.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), dsum.data_ptr(), b, s, h, kh, t, hd,
            hd ** -0.5, int(causal), int(window), _stream(q.device))
    raise_on_cuda_error("fs_flash_attention_bwd", err)
    obs.count("flash_bwd.launches")
    return dq, dk, dv


class FlashAttentionF32(torch.autograd.Function):
    """Float32 attention with a gradient and no (S, T) tensor:
    :func:`flash_attention_fwd_lse` forward → (out, lse), and
    :func:`flash_attention_bwd` backward from q, k, v, out and lse.  ``lse``
    is not differentiable.  Under ``torch.func.vmap`` a leading client axis
    of q, k and v folds into the batch (the positions are shared; a
    batched qpos or kpos raises)."""

    @staticmethod
    def forward(q, k, v, qpos, kpos, causal, window):
        return flash_attention_fwd_lse(q, k, v, qpos, kpos, causal=causal,
                                       window=window)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, qpos, kpos, causal, window = inputs
        out, lse = output
        ctx.save_for_backward(q, k, v, qpos, kpos, out, lse)
        ctx.causal, ctx.window = causal, window
        ctx.mark_non_differentiable(lse)

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, qpos, kpos, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout.contiguous(), lse, qpos,
                                         kpos, causal=ctx.causal, window=ctx.window)
        return dq, dk, dv, None, None, None, None

    @staticmethod
    def vmap(info, in_dims, q, k, v, qpos, kpos, causal, window):
        if in_dims[3] is not None or in_dims[4] is not None:
            raise ValueError("FlashAttentionF32 under vmap: qpos and kpos must be "
                             "shared by the batch")
        n = info.batch_size

        def fold(x, dim):
            x = x.unsqueeze(0).expand(n, *x.shape) if dim is None else x.movedim(dim, 0)
            return x.reshape(n * x.shape[1], *x.shape[2:]).contiguous()

        out, lse = FlashAttentionF32.apply(fold(q, in_dims[0]), fold(k, in_dims[1]),
                                           fold(v, in_dims[2]), qpos, kpos, causal,
                                           window)
        return ((out.reshape(n, -1, *out.shape[1:]), lse.reshape(n, -1, *lse.shape[1:])),
                (0, 0))


def flash_attention_train(q, k, v, qpos, kpos, *, causal: bool = True,
                          window: int = 0) -> torch.Tensor:
    """→ (B, S, H, hd) float32 through :class:`FlashAttentionF32`, so that
    autograd reaches q, k and v through the kernels' backward."""
    out, _ = FlashAttentionF32.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                                     qpos.to(torch.int32).contiguous(),
                                     kpos.to(torch.int32).contiguous(), causal, window)
    return out

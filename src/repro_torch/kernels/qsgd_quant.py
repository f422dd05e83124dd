"""QSGD stochastic quantize→dequantize for every client of a cohort, one leaf per call.

Port of ``repro/kernels/qsgd_quant.py::_qsgd_kernel``.  The CUDA kernel is
``csrc/qsgd_quant.cu`` (its note gives the design and the bound); this
module holds its plain PyTorch version and the wrapper.

One call covers one leaf for all N clients: ``x`` is ``(N, rows, cols)``
(the leaf's 2-D view, ``LeafLayout.rows``/``cols``), ``seeds`` the
``(N,)`` leaf-folded seeds ``fold_seed(ξ, tag)`` as int64 words, and
``norms`` the ``(N,)`` float32 L2 norms, computed outside as in the
reference, with a zero norm already replaced by 1.  The numeric spec, in
the reference's op order (float32 throughout)::

    L      = 2^(bits−1) − 1
    u      = (f32(hash_u32(seed, row, col, QSGD_TAG)) + 1) · 2⁻³²
    scaled = (|x| / norm) · L
    level  = ⌊scaled⌋ + 𝟙[u < scaled − ⌊scaled⌋]
    signed = sign(x) · level                     (the wire's level code)
    q      = ((norm · sign(x)) · level) / L      (= norm · signed / L)

``(row, col)`` are the coordinates of the 2-D view, with ``sign(0) = 0``.
``x`` is read as float32 and ``q`` rounded once to x's dtype (float32 or
bf16 on the card, as the reference writes ``o_ref.dtype``); the levels
are float32.
Both versions give the same bits for the same norms.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.prng import U32_MASK, hash_u32, uniform01
from repro_torch.kernels import _build
from repro_torch.kernels.common import (
    LEAF_DTYPES,
    check_cuda_tensor,
    raise_on_cuda_error,
    seeds_as_u32_bits,
)

__all__ = ["QSGD_TAG", "qsgd_quantize", "qsgd_quantize_plain"]

# Stream tag of the rounding uniforms (repro.core.qsgd.QSGD_TAG).
QSGD_TAG = 0x7FEB352D

# Elements per client group in the plain version (bounds its temporaries).
_PLAIN_GROUP_ELEMS = 1 << 22


def qsgd_quantize_plain(x: torch.Tensor, seeds: torch.Tensor,
                        norms: torch.Tensor, levels: int, want_q: bool = True,
                        want_levels: bool = False, row_offset: int = 0,
                        col_offset: int = 0):
    """Plain version of the kernel → ``(q or None, signed or None)``."""
    n, rows, cols = x.shape
    dev = x.device
    row = ((torch.arange(rows, dtype=torch.int64, device=dev) + row_offset)
           & U32_MASK)[None, :, None]
    col = ((torch.arange(cols, dtype=torch.int64, device=dev) + col_offset)
           & U32_MASK)[None, None, :]
    group = max(1, _PLAIN_GROUP_ELEMS // max(rows * cols, 1))
    # A device tensor, not a Python float: CUDA divides by a host scalar as
    # a multiply by its reciprocal, which is not the kernel's IEEE division.
    lv_f = torch.tensor(float(levels), dtype=torch.float32, device=dev)
    q_out = torch.empty_like(x) if want_q else None
    lv_out = (torch.empty(x.shape, dtype=torch.float32, device=dev)
              if want_levels else None)
    for g in range(0, n, group):
        sl = slice(g, g + group)
        s = (seeds[sl].to(torch.int64) & U32_MASK)[:, None, None]
        u = uniform01(hash_u32(s, row, col, QSGD_TAG))
        xf = x[sl].to(torch.float32)
        norm = norms[sl].to(torch.float32)[:, None, None]
        scaled = xf.abs() / norm * float(levels)
        floor = torch.floor(scaled)
        level = floor + (u < (scaled - floor)).to(torch.float32)
        sign = torch.sign(xf)
        if want_levels:
            lv_out[sl] = sign * level
        if want_q:
            q_out[sl] = (norm * sign * level / lv_f).to(x.dtype)
    return q_out, lv_out


def _lib():
    lib = _build.library("qsgd_quant")
    if not getattr(lib, "_fs_typed", False):
        p, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
        lib.fs_qsgd.argtypes = [p, p, p, p, p, i, i, i, i, u, u, i, p]
        lib.fs_qsgd.restype = i
        lib._fs_typed = True
    return lib


def qsgd_quantize(x: torch.Tensor, seeds: torch.Tensor, norms: torch.Tensor,
                  levels: int, want_q: bool = True, want_levels: bool = False,
                  row_offset: int = 0, col_offset: int = 0):
    """Quantize every client's leaf → ``(q or None, signed levels or None)``.

    ``q`` is the round trip in x's dtype, ``signed`` the float32 level
    codes; either pass writes only what is asked for.  A CUDA tensor
    launches the kernel (or raises); a CPU tensor takes the plain
    version.  ``qsgd_quantize.launches`` counts kernel launches.
    """
    if not (want_q or want_levels):
        raise ValueError("ask for q, the levels, or both")
    if x.device.type == "cpu":
        return qsgd_quantize_plain(x, seeds, norms, levels, want_q,
                                   want_levels, row_offset, col_offset)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    dev = x.device
    check_cuda_tensor("x", x, LEAF_DTYPES, 3, dev)
    check_cuda_tensor("seeds", seeds, torch.int64, 1, dev)
    check_cuda_tensor("norms", norms, torch.float32, 1, dev)
    n, rows, cols = x.shape
    if seeds.numel() != n or norms.numel() != n:
        raise ValueError(f"seeds {seeds.numel()} / norms {norms.numel()} do "
                         f"not match x {tuple(x.shape)}")
    if not 1 <= levels <= 127:
        raise ValueError(f"levels {levels} outside 1..127 (bits 2..8)")
    if n > 65535:
        raise ValueError(f"x {tuple(x.shape)}: more clients than the launch grid holds")
    lib = _lib()
    q = torch.empty_like(x) if want_q else None
    lv = torch.empty(x.shape, dtype=torch.float32, device=dev) if want_levels else None
    seeds32 = seeds_as_u32_bits(seeds)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fs_qsgd(
            x.data_ptr(), seeds32.data_ptr(), norms.data_ptr(),
            q.data_ptr() if want_q else None, lv.data_ptr() if want_levels else None,
            n, rows, cols, levels, row_offset & U32_MASK, col_offset & U32_MASK,
            LEAF_DTYPES[x.dtype], stream)
    raise_on_cuda_error("fs_qsgd", err)
    qsgd_quantize.launches += 1
    return q, lv


qsgd_quantize.launches = 0

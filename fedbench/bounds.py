"""The yardstick: the card's peaks and the least time of each measured kernel.

Peaks are an NVIDIA H100 SXM's (data sheet, dense rates, at its full
700 W).  Instruction rates are results per clock per SM from the CUDA
C++ Programming Guide's throughput table for compute capability 9.0
(128 for float32 add or multiply, 64 for 32-bit integer add, logic,
shift, compare and multiply), times 132 SMs at 1.98 GHz.

The FedScalar kernels' counts come from the SplitMix32 chain that
defines a seeded direction (``reference/chain.py``): after the hoisted
per-(seed, row) rounds, each (element, client, block) needs 9 integer
add/logic/shift/select ops, 2 integer multiplies and a float32 multiply
and add; each (row, client, block) two SplitMix32 rounds and two xors.
A kernel's least time is the larger of its bytes over HBM and each op
class over its own rate.  Bytes count what the inputs need: each input
read once and each output written once.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
BF16_DENSE_FLOP_PER_S = 989e12
FP32_OPS_PER_S = 132 * 128 * 1.98e9        # 33.5e12 non-FMA float32 ops/s
INT32_OPS_PER_S = 132 * 64 * 1.98e9        # 16.7e12 int32 ops/s, each class
ISSUE_PER_S = 132 * 128 * 1.98e9           # all instructions together

ELEM_OPS = {"int": 9, "imul": 2, "fp": 2}
ROW_OPS = {"int": 16, "imul": 4, "fp": 0}


def bound_s(nbytes: float, shapes, n: int, k: int) -> float:
    """Least seconds of a FedScalar tree kernel over ``shapes`` (rows, cols)
    for ``n`` clients and ``k`` blocks moving ``nbytes``."""
    d = sum(r * c for r, c in shapes)
    rows = sum(r for r, _ in shapes)
    ops = {c: n * k * (ELEM_OPS[c] * d + ROW_OPS[c] * rows) for c in ELEM_OPS}
    t_ops = max(ops["int"] / INT32_OPS_PER_S, ops["imul"] / INT32_OPS_PER_S,
                ops["fp"] / FP32_OPS_PER_S, sum(ops.values()) / ISSUE_PER_S)
    return max(nbytes / HBM_BYTES_PER_S, t_ops)


def encode_bound_s(shapes, n: int, k: int = 1, elem: int = 4) -> float:
    """The encode: δ read once (``elem`` bytes an element), r written."""
    d = sum(r * c for r, c in shapes)
    return bound_s(elem * n * d + 4 * n * k * len(shapes), shapes, n, k)


def decode_bound_s(shapes, n: int, k: int = 1, elem: int = 4) -> float:
    """The close: x read and the new x written once, seeds and scalars."""
    d = sum(r * c for r, c in shapes)
    return bound_s(2 * elem * d + len(shapes) * n * (4 + 4 * k), shapes, n, k)


def train_flops(n_nonembed: int, d_model: int, vocab: int, layers: int, heads: int,
                head_dim: int, seq: int, tokens: int) -> float:
    """The model FLOPs of forward and backward over ``tokens`` tokens in
    sequences of ``seq``, with no recompute: 3 × (the non-embedding
    matmuls' 2·N·tokens + the output head's 2·d·V·tokens + causal
    attention's 4·L·tokens·(seq/2)·heads·head_dim).  The input
    embedding is a lookup and counts nothing."""
    fwd = (2 * n_nonembed * tokens + 2 * d_model * vocab * tokens
           + 4 * layers * tokens * (seq / 2) * heads * head_dim)
    return 3 * fwd

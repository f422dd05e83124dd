"""Plain reference of the FedScalar server's synchronous round close.

What the aggregator must apply, worked out again from the traffic: an
upload applies in its round when the channel did not lose it and it
arrived by the round's deadline; the applied uploads keep the order in
which they were offered (client-id order), and each carries its
Horvitz–Thompson weight unchanged (a synchronous round has no staleness
discount).

What the close must compute: with the applied uploads' seeds ξᵢ,
scalars rᵢ and weights wᵢ,

    x ← round_to_x_dtype(x + lr · Σᵢ wᵢ·rᵢ·v(ξᵢ))

Each element's new value depends only on its old value and the round's
uploads, so the chain can be followed over every round of a run on a
sample of elements: :func:`close_chain`.  The sum is taken in float64
(the reference) or, for the control, term by term in bfloat16 (the
precision below the float32 accumulation the configuration states).
"""
from __future__ import annotations

import numpy as np
import torch

from fedbench.reference.chain import leaf_seeds, signs


def applied(rnd: dict, deadline_s: float):
    """→ (seeds uint32, r float32, weights float64) of the uploads that apply."""
    keep = (~rnd["lost"]) & (rnd["latency_s"] <= deadline_s)
    return rnd["seeds"][keep], rnd["r"][keep], rnd["weights"][keep]


def close_chain(x0: torch.Tensor, tags: torch.Tensor, rows: torch.Tensor,
                cols: torch.Tensor, rounds, lr: float, acc: str = "float64",
                dtype=torch.bfloat16, block: int = 256) -> torch.Tensor:
    """Follow sampled elements through every round's close.

    ``x0`` (E,) float64 holds the starting values, of the model's
    ``dtype``; ``tags``, ``rows`` and ``cols`` (E,) int64 locate each
    element; ``rounds`` yields ``(seeds (A,) int64, coef (A,) float64)``
    with coef = w·r.  → (E,) float64 holding the values after the last
    round, each round's rounded to ``dtype``.
    """
    x = x0.clone()
    for seeds, coef in rounds:
        if acc == "float64":
            tot = torch.zeros_like(x)
            for b in range(0, len(seeds), block):
                v = signs(leaf_seeds(seeds[b:b + block], tags), rows[None], cols[None])
                tot += (coef[b:b + block, None] * v).sum(0)
        elif acc == "bfloat16":
            tot = torch.zeros(x.shape, dtype=torch.bfloat16, device=x.device)
            for b in range(0, len(seeds), block):
                v = signs(leaf_seeds(seeds[b:b + block], tags), rows[None], cols[None])
                terms = (coef[b:b + block, None] * v).to(torch.bfloat16)
                for t in terms:
                    tot = tot + t
            tot = tot.to(torch.float64)
        else:
            raise ValueError(f"accumulation {acc!r}")
        x = (x + lr * tot).to(torch.float32).to(dtype).to(torch.float64)
    return x


def compare(x_prog: torch.Tensor, x_ref: torch.Tensor, x0: torch.Tensor) -> dict:
    """The numbers held against their limits: the relative error of the
    whole run's update and the share of sampled elements that differ."""
    du_p, du_r = x_prog - x0, x_ref - x0
    denom = float(torch.linalg.vector_norm(du_r))
    return {
        "x_update_rel_err": float(torch.linalg.vector_norm(du_p - du_r)) / max(denom, 1e-300),
        "x_mismatch_share": float((x_prog != x_ref).to(torch.float64).mean()),
    }


def sets_agree(prog_rounds, traffic_rounds, deadline_s: float) -> dict:
    """Per round, the program's applied (seeds, coefficients, scalars)
    against those worked out from the traffic → mismatch counts."""
    set_bad, coef_err, r_bad = 0, 0.0, 0
    for (pseeds, pcoef, prs), rnd in zip(prog_rounds, traffic_rounds):
        seeds, r, w = applied(rnd, deadline_s)
        if len(pseeds) != len(seeds) or not np.array_equal(
                np.asarray(pseeds, np.uint32), seeds):
            set_bad += 1
            continue
        coef_err = max(coef_err, float(np.max(np.abs(np.asarray(pcoef, np.float64) - w),
                                              initial=0.0)))
        r_bad += int(np.sum(np.asarray(prs, np.float32).reshape(-1) != r))
    return {"applied_set_mismatch": set_bad, "weight_max_abs_diff": coef_err,
            "scalar_mismatch": r_bad}

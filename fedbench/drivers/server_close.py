"""``server_close``: a backlogged FedScalar server closing synchronous rounds.

Set-up builds one ``EngineCore`` of the port around a model's
parameters (drawn by the harness from ``--seed``), draws the rounds'
uploads from the traffic file, and closes the traffic's warm-up rounds.
The window then closes round after round, back to back, as the
runtime's synchronous loop calls the server
(``fed/runtime/scheduler.py``'s sync loop):

    EngineCore.offer_uploads → StreamingAggregator.close_round(k)
      → EngineCore.apply_round → FedScalarProtocol.server_apply
      → the per-client decode kernel (cohorts of 512 and more)

until ``--seconds`` have passed; the window ends with the last whole
round.  Nothing the program computes is fed back: the uploads are the
traffic's.

Checks, once the window has closed and the program's state is freed:
every round's applied seeds, weights and scalars against those worked
out from the traffic (exact), and a sample of the model's elements,
drawn from the seed in every leaf, followed by the plain reference from
the harness's starting values through every round the program closed
(``reference/server.py``).
"""
from __future__ import annotations

import math
import time
from types import SimpleNamespace

import numpy as np
import torch

from fedbench.harness import Run, gather, leaf_paths, make_weights, sample_elements
from fedbench.reference import server as ref
from fedbench.traffic import Uploads

DECODE_KERNEL = "decode_tree_kernel"


def _unused(*_a, **_k):
    raise AssertionError("the server cell runs no client computation")


def build_core(run: Run, params, sizes: np.ndarray):
    """The port's round driver around ``params``, its server alone used."""
    from repro_torch.core.prng import Distribution
    from repro_torch.core.projection import tree_size
    from repro_torch.fed.runtime.engine import EngineCore, RuntimeConfig
    from repro_torch.fed.runtime.server import ServerConfig

    tp = run.traffic
    cfg = RuntimeConfig(
        population=int(tp["population"]), participation=float(tp["participation"]),
        sampler="weighted", protocol_name="fedscalar", server_lr=float(tp["server_lr"]),
        distribution=Distribution.RADEMACHER, num_projections=1, projection_mode="full",
        seed=run.seed & 0xFFFFFFFF, server=ServerConfig(deadline_s=float(tp["deadline_s"])))
    proto = cfg.build_protocol(params)
    one = (np.zeros((1, 1), np.float32), np.zeros(1, np.int64))
    return EngineCore(cfg, params, [one], one[0], one[1], _unused, (_unused, _unused),
                      sizes, proto, tree_size(params), run.device)


def run(run: Run) -> dict:
    from repro_torch.configs.registry import get_arch

    tp = run.traffic
    lr, deadline = float(tp["server_lr"]), float(tp["deadline_s"])
    run.mark("import")
    like = get_arch(run.config["registry_name"]).param_shapes()
    shapes = [tuple(leaf.shape) for _, leaf in leaf_paths(like)]
    params = make_weights(like, run.seed, run.device)
    traffic = Uploads(tp, run.seed)
    core = build_core(run, params, traffic.sizes)
    run.mark("weights and engine")

    tags, flat, rows, cols = sample_elements(shapes, int(tp["check_elements"]),
                                             int(tp["check_floor"]), run.seed)
    x0 = gather(params, tags, flat)

    warm = int(tp["warmup_rounds"])
    ahead = warm + math.ceil(run.seconds * 1e3 / float(tp["fastest_round_ms"]))
    rounds = [traffic.round(k) for k in range(ahead)]
    closed, applied, close_s = [], [], []
    run.mark("traffic")

    def close(k, params):
        if k == len(rounds):
            rounds.append(traffic.round(k))
        rnd = rounds[k]
        tx = SimpleNamespace(seeds=rnd["seeds"], r_hat=rnd["r"][:, None],
                             latency_s=rnd["latency_s"], lost=rnd["lost"])
        with run.span("offer"):
            core.offer_uploads(rnd["ids"], rnd["weights"], k, tx)
        t0 = time.perf_counter()
        with run.span("close_round"):
            aseeds, acoeffs, ars, st = core.agg.close_round(k)
        with run.span("apply_round"):
            params, _, _ = core.apply_round(params, aseeds, acoeffs, ars, len(rnd["ids"]), st)
        close_s.append(time.perf_counter() - t0)
        closed.append((aseeds, acoeffs, ars))
        applied.append(st.applied)
        return params

    for k in range(warm):
        params = close(k, params)
        run.mark(f"warm-up close {k}")
    close_s.clear()
    applied.clear()

    run.window_begin()
    k = warm
    while True:
        params = close(k, params)
        k += 1
        if time.perf_counter() - run.t_window >= run.seconds:
            break
    run.window_end()

    x_prog = gather(params, tags, flat)
    del params, core
    if run.device.type == "cuda":
        torch.cuda.empty_cache()

    checks = ref.sets_agree(closed, rounds[:k], deadline)
    dev = run.device
    t = {n: torch.from_numpy(a).to(dev) for n, a in
         (("tags", tags), ("rows", rows), ("cols", cols))}
    x_ref = ref.close_chain(torch.from_numpy(x0).to(dev), t["tags"], t["rows"], t["cols"],
                            _ref_rounds(rounds[:k], deadline, dev), lr,
                            dtype=like_dtype(like))
    checks.update(ref.compare(torch.from_numpy(x_prog).to(dev), x_ref,
                              torch.from_numpy(x0).to(dev)))

    n = len(close_s)
    return {
        "e2e": {"server_uploads_per_s": sum(applied) / run.window_s,
                "close_ms_p95": float(np.percentile(np.array(close_s) * 1e3, 95)),
                "peak_mem_gib": (run.peak_bytes or 0) / 2 ** 30,
                "setup_s": run.setup_s},
        "counters": {"rounds": n, "applied": applied, "decode_shapes": [
            (int(np.prod(s[:-1])) if len(s) > 1 else 1, int(s[-1])) for s in shapes],
            "elem_bytes": torch.finfo(like_dtype(like)).bits // 8,
            "decode_kernel": DECODE_KERNEL},
        "checks": checks,
        "attempted": n,
        "failed": 0,
    }


def like_dtype(like):
    return leaf_paths(like)[0][1].dtype


def _ref_rounds(rounds, deadline: float, dev):
    """Each round's applied uploads as the reference works them out."""
    for rnd in rounds:
        seeds, r, w = ref.applied(rnd, deadline)
        coef = w * r.astype(np.float64)
        yield (torch.from_numpy(seeds.astype(np.int64)).to(dev),
               torch.from_numpy(coef).to(dev))

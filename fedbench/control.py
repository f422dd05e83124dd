#!/usr/bin/env python3
"""Readings that set a cell's correctness limits; the benchmark's runs never call this.

    python3 fedbench/control.py --workload <cell> --mode <mode> --seeds <n> [<n> ...]
        [--seconds <s>] [--rounds <R>]

Modes, each on the card at the cell's own size, one line of JSON per seed:

* ``sound``   — the program as it is: one whole run of the cell per seed
  (``--seconds`` of window), its compared numbers;
* ``control`` — the plain reference put in the program's place and
  computed in the precision below the one the configuration states
  (the server's close summed term by term in bfloat16 where the program
  sums in float32, over ``--rounds`` rounds of the seed's traffic; a
  training round with every matmul operand in float8), held against
  the reference by the same numbers;
* ``faults``  — the program with a fault planted underneath the timed
  path (:data:`FAULTS`), one run of each per seed.

The lower reading of a number is the largest that sound runs give, the
upper the smallest that the control gives; each limit lies between.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


@contextlib.contextmanager
def planted(fault: str, driver: str = "server_close"):
    """A fault under a cell's timed path, undone on exit.

    ``unchanged``: every step returns the model as it was.
    ``half_batch``: half of the step's batch is left out and the mean taken
    over the rest (the server: the first half of each close's uploads at
    twice their weight; training: the close of the first client alone).
    ``altered``: an answer altered where it is produced: the first close's
    new model keeps its first leaf's old values.
    """
    from repro_torch.core.tree import tree_leaves, tree_unflatten
    from repro_torch.fed.runtime import engine, server
    from repro_torch.kernels import ops
    from repro_torch.launch import train

    saved = [(engine.EngineCore, "apply_round"), (server.StreamingAggregator, "close_round"),
             (train, "make_train_step"), (ops, "server_update_kernel")]
    saved = [(o, n, getattr(o, n)) for o, n in saved]
    orig_apply, orig_close, orig_make, orig_close_kernel = (f for _, _, f in saved)
    calls = []

    def unchanged_apply(self, params, *a, **k):
        return params, False, 0.0

    def half_batch_close(self, k):
        seeds, coeffs, rs, st = orig_close(self, k)
        h = max(1, len(seeds) // 2)
        return seeds[:h], coeffs[:h] * 2.0, rs[:h], st

    def altered_apply(self, params, *a, **k):
        new, method, s = orig_apply(self, params, *a, **k)
        calls.append(1)
        if len(calls) == 1:
            leaves = tree_leaves(new)
            leaves[0] = tree_leaves(params)[0]
            new = tree_unflatten(new, leaves)
        return new, method, s

    def unchanged_make(*a, **k):
        step = orig_make(*a, **k)

        def same(params, batch, round_idx):
            _, met = step(params, batch, round_idx)
            return params, met
        return same

    def half_batch_kernel(params, rs, seeds, *a, **k):
        return orig_close_kernel(params, rs[:1], seeds[:1], *a, **k)

    def altered_kernel(params, *a, **k):
        new = orig_close_kernel(params, *a, **k)
        calls.append(1)
        if len(calls) == 1:
            leaves = tree_leaves(new)
            leaves[0] = tree_leaves(params)[0]
            new = tree_unflatten(new, leaves)
        return new

    plants = {
        "server_close": {"unchanged": (engine.EngineCore, "apply_round", unchanged_apply),
                         "half_batch": (server.StreamingAggregator, "close_round",
                                        half_batch_close),
                         "altered": (engine.EngineCore, "apply_round", altered_apply)},
        "fedround": {"unchanged": (train, "make_train_step", unchanged_make),
                     "half_batch": (ops, "server_update_kernel", half_batch_kernel),
                     "altered": (ops, "server_update_kernel", altered_kernel)},
    }
    owner, name, fn = plants[driver][fault]
    setattr(owner, name, fn)
    try:
        yield
    finally:
        for o, n, f in saved:
            setattr(o, n, f)


FAULTS = ("unchanged", "half_batch", "altered")


def control_readings(cell: str, seed: int, rounds: int, device: str = "cuda",
                     root: Path = ROOT) -> dict:
    """The cell's control held against its reference by the cell's numbers:
    the server's close summed in bfloat16 against the float64 close over
    ``rounds`` rounds of the seed's traffic; training's float32 reference
    with every matmul operand in float8 against the float32 reference."""
    import torch

    from fedbench.harness import Run, gather, leaf_paths, make_weights, sample_elements
    from fedbench.run import load_manifest, resolve
    from repro_torch.configs.registry import get_arch

    c = resolve(load_manifest(root), cell, root)
    tp, dev = c["traffic"], torch.device(device)
    like = get_arch(c["config"]["registry_name"]).param_shapes()
    if tp["driver"] == "fedround":
        from fedbench.drivers import fedround as drv
        from fedbench.reference.train import fp8_quant

        run = Run(config=c["config"], traffic=tp, seed=seed, seconds=0.0, trace=False,
                  device=dev, t_start=time.perf_counter())
        _, _, batch = drv.setup(run)
        base = drv.round_base(seed)
        want = drv.reference_rounds(run, like, batch, base)
        got = drv.reference_rounds(run, like, batch, base, quant=fp8_quant)
        return drv.compare(got, want) | {"losses": got["losses"], "ref_losses": want["losses"],
                                         "rs": got["rs"][0], "ref_rs": want["rs"][0]}

    from fedbench.drivers import server_close as drv
    from fedbench.reference import server as ref
    from fedbench.traffic import Uploads

    shapes = [tuple(leaf.shape) for _, leaf in leaf_paths(like)]
    tags, flat, rows, cols = sample_elements(shapes, int(tp["check_elements"]),
                                             int(tp["check_floor"]), seed)
    params = make_weights(like, seed, dev)
    x0 = torch.from_numpy(gather(params, tags, flat)).to(dev)
    del params
    traffic = Uploads(tp, seed)
    rnds = [traffic.round(k) for k in range(rounds)]
    loc = [torch.from_numpy(a).to(dev) for a in (tags, rows, cols)]
    deadline, lr = float(tp["deadline_s"]), float(tp["server_lr"])
    want = ref.close_chain(x0, *loc, drv._ref_rounds(rnds, deadline, dev), lr,
                           dtype=drv.like_dtype(like))
    got = ref.close_chain(x0, *loc, drv._ref_rounds(rnds, deadline, dev), lr,
                          acc="bfloat16", dtype=drv.like_dtype(like))
    return ref.compare(got, want, x0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--mode", choices=("sound", "control", "faults"), required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--rounds", type=int, default=100)
    args = ap.parse_args(argv)
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    from fedbench.run import load_manifest, resolve, run_cell

    driver = resolve(load_manifest(ROOT), args.workload, ROOT)["traffic"]["driver"]
    for seed in args.seeds:
        t0 = time.perf_counter()
        if args.mode == "control":
            rows = [("control", control_readings(args.workload, seed, args.rounds))]
        else:
            rows = []
            for fault in (FAULTS if args.mode == "faults" else (None,)):
                with planted(fault, driver) if fault else contextlib.nullcontext():
                    res = run_cell(args.workload, seed, args.seconds, False,
                                   t_start=time.perf_counter())
                rows.append((fault or "sound", {k: v["value"] for k, v in res["checks"].items()}
                             | {"correct": res["correct"], "rounds": res["attempted"]}))
        for name, readings in rows:
            print(json.dumps({"seed": seed, "mode": name, "readings": readings,
                              "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

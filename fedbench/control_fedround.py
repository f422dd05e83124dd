#!/usr/bin/env python3
"""Readings that set the correctness limits of a ``fedround_sized`` cell; the
benchmark's runs never call this.

    python3 fedbench/control_fedround.py --workload <cell> --mode <mode> --seeds <n> [<n> ...]
        [--seconds <s>]

Modes, each on the card at the cell's own size, one line of JSON per seed:

* ``sound``   — the program as it is: one whole run of the cell per seed
  (``--seconds`` of window), its compared numbers;
* ``control`` — the plain reference in the program's place, every matmul
  operand cast to the precision below the configuration's dtype
  (``reference/dense.py::quant_below``: bfloat16 below float32, float8
  below bfloat16), over the checked rounds on its own uploads, held
  against the reference by the same numbers as the program;
* ``faults``  — the program with each of ``control.FAULTS`` planted under
  the timed path (``control.planted``'s training faults), one run of
  each per seed.

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


def control_readings(cell: str, seed: int, device: str = "cuda", root: Path = ROOT) -> dict:
    """The reference computed one precision below the configuration's dtype,
    against the reference, by the cell's compared numbers."""
    import torch

    from fedbench.drivers import fedround_sized as drv
    from fedbench.harness import Run
    from fedbench.reference.dense import quant_below
    from fedbench.run import load_manifest, resolve

    c = resolve(load_manifest(root), cell, root)
    run = Run(config=c["config"], traffic=c["traffic"], seed=seed, seconds=0.0, trace=False,
              device=torch.device(device), t_start=time.perf_counter())
    like, _, batch = drv.setup(run)
    base = drv.round_base(seed)
    got = drv.reference_rounds(run, like, batch, base,
                               quant=quant_below(c["config"]["torch_dtype"]))
    want = drv.reference_rounds(run, like, batch, base, follow=got["rs"])
    return drv.compare(got, want) | {"losses": got["losses"], "ref_losses": want["losses"],
                                     "rs": got["rs"], "ref_rs": want["rs"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--mode", choices=("sound", "control", "faults"), required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    args = ap.parse_args(argv)
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    from fedbench.control import FAULTS, planted
    from fedbench.run import run_cell

    for seed in args.seeds:
        t0 = time.perf_counter()
        if args.mode == "control":
            rows = [("control", control_readings(args.workload, seed))]
        else:
            rows = []
            for fault in (FAULTS if args.mode == "faults" else (None,)):
                with planted(fault, "fedround") if fault else contextlib.nullcontext():
                    res = run_cell(args.workload, seed, args.seconds, False,
                                   t_start=time.perf_counter())
                rows.append((fault or "sound", {k: v["value"] for k, v in res["checks"].items()}
                             | {"correct": res["correct"], "rounds": res["attempted"],
                                "metrics": {k: v["value"] for k, v in res["metrics"].items()}}))
        for name, readings in rows:
            print(json.dumps({"seed": seed, "mode": name, "readings": readings,
                              "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""``fedround``: whole FedScalar training rounds of a language model, back to back.

Set-up draws the parameters on the card from ``--seed``, builds the
port's round (``launch/train.py::make_train_step``: each client's local
SGD in turn, the encode kernel, the per-client-rounding close) and
drives it through the traffic's first ``checked_rounds`` rounds, by the
window's own call and feed, each round on fresh token rows.  Those
rounds warm every shape and are the ones the checks read.  The window
then runs whole rounds until ``--seconds`` have passed and ends with
the last one.

Checks, once the window has closed and the program's state is freed:

* the plain float32 reference (``reference/train.py``) follows the
  checked rounds from the same starting parameters on its own: each
  round's loss, and the first round's uploads r, against the program's;
* the close, followed from the program's own state on a sample of
  elements drawn from the seed in every leaf: from the starting values
  and each round's uploads as the program reported them, the sampled
  elements after each round must be the program's to the bit.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from fedbench.bounds import train_flops
from fedbench.harness import Run, gather, leaf_paths, leaf_weights, make_weights, sample_elements
from fedbench.reference import decoder
from fedbench.reference import train as tref
from fedbench.traffic import M64, token_batch

ENCODE_KERNELS = ("project_tree_kernel", "sum_tree_partials_kernel")


def round_base(seed: int) -> int:
    """The first round's index, drawn from the seed, so that each seed has
    its own round seeds ξ."""
    return ((int(seed) * 0x9E3779B97F4A7C15) & M64) >> 33


def setup(run: Run):
    """→ (parameter shapes, the program's round, the traffic's batches)."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.core.prng import Distribution
    from repro_torch.launch.train import FLRunConfig, make_train_step

    tp, dev = run.traffic, run.device
    arch = get_arch(run.config["registry_name"])
    fl = FLRunConfig(num_virtual_clients=int(tp["clients"]),
                     local_steps=int(tp["local_steps"]), local_lr=float(tp["local_lr"]),
                     server_lr=float(tp["server_lr"]), distribution=Distribution.RADEMACHER,
                     num_projections=1)
    vocab = int(run.config["vocab_size"])

    def batch(k):
        tok, lab = token_batch(tp, vocab, run.seed, k)
        return {"tokens": torch.from_numpy(tok).to(dev),
                "labels": torch.from_numpy(lab).to(dev)}

    return arch.param_shapes(), make_train_step(arch, fl), batch


def reference_rounds(run: Run, like, batch, base: int, quant=None) -> dict:
    """The reference on its own over the checked rounds → each round's mean
    loss and uploads."""
    tp, dev = run.traffic, run.device
    n = int(tp["clients"])
    m = decoder.dims(run.config)
    paths = leaf_paths(like)
    tags = {p: t for t, (p, _) in enumerate(paths)}
    tree = {p: leaf_weights(p, tuple(t.shape), run.seed, tags[p], t.dtype, dev)
            for p, t in paths}
    losses, rs = [], []
    for k in range(int(tp["checked_rounds"])):
        b = batch(k)
        seeds = tref.round_seeds(base + k, n)
        r, ls = [], []
        for c in range(n):
            lv, rc = tref.client_round(tree, tags, m, b["tokens"][c], b["labels"][c],
                                       float(tp["local_lr"]), seeds[c], quant)
            r.append(rc)
            ls.append(lv)
        losses.append(sum(ls) / n)
        rs.append(r)
        if k + 1 < int(tp["checked_rounds"]):
            tree = tref.close(tree, tags, r, seeds, float(tp["server_lr"]))
    return {"losses": losses, "rs": rs}


def compare(prog: dict, ref: dict) -> dict:
    """Each round's loss, and the first round's uploads against the round's
    root mean square upload."""
    r0p, r0r = np.array(prog["rs"][0]), np.array(ref["rs"][0])
    return {"loss_rel_gap": max(abs(a - b) / abs(b)
                                for a, b in zip(prog["losses"], ref["losses"])),
            "first_r_gap": float(np.max(np.abs(r0p - r0r)) / np.sqrt(np.mean(r0r ** 2)))}


def close_mismatch(run: Run, like, samples: list, rs: list, base: int) -> float:
    """The share of sampled elements whose value after a checked round
    differs from the close of the program's values before it with the
    program's uploads."""
    tp, dev = run.traffic, run.device
    tags, flat, rows, cols = samples[0]
    loc = [torch.from_numpy(a).to(dev) for a in (tags, rows, cols)]
    dtype = leaf_paths(like)[0][1].dtype
    bad = 0
    for k, (before, after) in enumerate(zip(samples[1:], samples[2:])):
        want = tref.close_samples(torch.from_numpy(before).to(dev, torch.float32), *loc,
                                  rs[k], tref.round_seeds(base + k, len(rs[k])),
                                  float(tp["server_lr"]), dtype)
        bad += int((want.to(torch.float64).cpu().numpy() != after).sum())
    return bad / (len(flat) * (len(samples) - 2))


def run(run: Run) -> dict:
    tp, dev = run.traffic, run.device
    run.mark("import")
    like, step, batch = setup(run)
    base = round_base(run.seed)
    shapes = [tuple(t.shape) for _, t in leaf_paths(like)]
    where = sample_elements(shapes, int(tp["check_elements"]), int(tp["check_floor"]),
                            run.seed)
    params = make_weights(like, run.seed, dev)
    samples = [where, gather(params, where[0], where[1])]
    run.mark("weights")
    prog = {"losses": [], "rs": []}
    for k in range(int(tp["checked_rounds"])):
        with run.span("train_step"):
            params, met = step(params, batch(k), base + k)
        prog["losses"].append(float(met["loss"]))
        prog["rs"].append(met["r"][:, 0].tolist())
        samples.append(gather(params, where[0], where[1]))
        run.mark(f"checked round {k}")
    del met

    run.window_begin()
    k = start = int(tp["checked_rounds"])
    while True:
        with run.span("train_step"):
            params, _ = step(params, batch(k), base + k)
        k += 1
        if time.perf_counter() - run.t_window >= run.seconds:
            break
    run.window_end()
    rounds = k - start

    del params, step
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks = compare(prog, reference_rounds(run, like, batch, base))
    checks["close_mismatch_share"] = close_mismatch(run, like, samples, prog["rs"], base)

    m = decoder.dims(run.config)
    tokens = int(tp["rows_per_round"]) * int(tp["seq_len"])
    total = sum(int(np.prod(s)) for s in shapes)
    embed = m["vocab"] * m["d"] * (1 if m["tied"] else 2)
    flops = train_flops(total - embed, m["d"], m["vocab"], m["layers"], m["h"], m["hd"],
                        int(tp["seq_len"]), tokens)
    return {
        "e2e": {"train_tokens_per_s": rounds * tokens / run.window_s,
                "peak_mem_gib": (run.peak_bytes or 0) / 2 ** 30,
                "setup_s": run.setup_s},
        "counters": {"rounds": rounds, "flops_per_round": flops,
                     "encodes_per_round": int(tp["clients"]) * int(tp["local_steps"]),
                     "encode_shapes": [(int(np.prod(s[:-1])) if len(s) > 1 else 1, int(s[-1]))
                                       for s in shapes],
                     "elem_bytes": torch.finfo(leaf_paths(like)[0][1].dtype).bits // 8,
                     "encode_kernels": list(ENCODE_KERNELS)},
        "checks": checks,
        "attempted": rounds,
        "failed": 0,
    }

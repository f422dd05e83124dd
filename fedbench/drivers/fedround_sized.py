"""``fedround_sized``: whole FedScalar training rounds of a language model built
at its configuration file's sizes, back to back.

The model is the port's registry entry (``registry_name``) with every size
the file states put over it by ``dataclasses.replace``: depth, hidden,
query and K/V heads, head size, MLP width and kind, norm, vocabulary,
tying, rotary base and share, and dtype.  It runs the port's normal path:
``models.api.Arch`` and ``launch/train.py::make_train_step`` (each
client's local SGD in turn, the encode kernel, the per-client-rounding
close).  Set-up draws the parameters on the card from ``--seed`` and
drives the traffic's first ``checked_rounds`` rounds, each on fresh token
rows; they warm every shape and are the rounds the checks read.  The
window then runs whole rounds until ``--seconds`` have passed and ends
with the last one.  ``server_uploads_per_s`` is the uploads the window's
closes applied (clients × rounds) over its length.

Checks, once the window has closed and the program's state is freed:

* the plain float32 reference (``reference/dense.py``, TF32 off) takes
  each checked round's local steps from the parameters the program
  started that round with: the harness's starting values, then each
  round closed by the reference with the program's uploads (a close that
  ``close_mismatch_share`` holds to the bit).  ``loss_rel_gap`` is the
  largest relative gap of a round's mean loss, ``r_gap`` the largest gap
  of an upload r over every checked round and client, over the round's
  root mean square reference upload.  A reference that followed its own
  uploads would carry each round's gap into the next, and a close moves
  each element by ±r/N, some 10⁵ times what a local step moves it: the
  later rounds' gaps would then measure that, not the program;
* ``close_mismatch_share``: the close followed from the program's own
  state on a sample of elements drawn from the seed in every leaf; from
  the values before a checked round and that round's uploads as the
  program reported them, the sampled elements after it must be the
  program's to the bit.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from fedbench.drivers.fedround import close_mismatch, round_base
from fedbench.harness import Run, gather, leaf_paths, leaf_weights, make_weights, sample_elements
from fedbench.reference import dense
from fedbench.reference.train import close as ref_close
from fedbench.reference.train import round_seeds
from fedbench.traffic import token_batch

ENCODE_KERNELS = ("project_tree_kernel", "sum_tree_partials_kernel")
DECODE_KERNEL = "decode_tree_kernel"
ACTIVATIONS = {"silu": "swiglu", "relu2": "relu2"}


def model_config(cfg: dict):
    """The port's ``ModelConfig`` at the configuration file's sizes."""
    from repro_torch.configs.registry import get_config

    return dataclasses.replace(
        get_config(cfg["registry_name"]), num_layers=int(cfg["num_hidden_layers"]),
        d_model=int(cfg["hidden_size"]), num_heads=int(cfg["num_attention_heads"]),
        num_kv_heads=int(cfg["num_key_value_heads"]), head_dim=int(cfg["head_dim"]),
        d_ff=int(cfg["intermediate_size"]), vocab_size=int(cfg["vocab_size"]),
        activation=ACTIVATIONS[cfg["hidden_act"]], norm=cfg["norm"],
        tie_embeddings=bool(cfg["tie_word_embeddings"]), rope_theta=float(cfg["rope_theta"]),
        partial_rotary_factor=float(cfg.get("partial_rotary_factor", 1.0)),
        dtype=cfg["torch_dtype"])


def setup(run: Run):
    """→ (parameter shapes, the program's round, the traffic's batches)."""
    from repro_torch.core.prng import Distribution
    from repro_torch.launch import train
    from repro_torch.models.api import Arch

    tp, dev = run.traffic, run.device
    arch = Arch(model_config(run.config))
    fl = train.FLRunConfig(num_virtual_clients=int(tp["clients"]),
                           local_steps=int(tp["local_steps"]), local_lr=float(tp["local_lr"]),
                           server_lr=float(tp["server_lr"]),
                           distribution=Distribution.RADEMACHER, num_projections=1)
    vocab = int(run.config["vocab_size"])

    def batch(k):
        tok, lab = token_batch(tp, vocab, run.seed, k)
        return {"tokens": torch.from_numpy(tok).to(dev),
                "labels": torch.from_numpy(lab).to(dev)}

    return arch.param_shapes(), train.make_train_step(arch, fl), batch


def reference_rounds(run: Run, like, batch, base: int, quant=None, follow=None) -> dict:
    """The reference over the checked rounds → each round's mean loss and
    uploads.  Each round closes with the uploads ``follow`` gives for it
    (those of the side under test, so that both sides start every round
    from the same parameters), or with its own."""
    tp, dev = run.traffic, run.device
    n = int(tp["clients"])
    m = dense.dims(run.config)
    paths = leaf_paths(like)
    tags = {p: t for t, (p, _) in enumerate(paths)}
    tree = {p: leaf_weights(p, tuple(t.shape), run.seed, tags[p], t.dtype, dev)
            for p, t in paths}
    losses, rs = [], []
    for k in range(int(tp["checked_rounds"])):
        b = batch(k)
        seeds = round_seeds(base + k, n)
        r, ls = [], []
        for c in range(n):
            lv, rc = dense.client_round(tree, tags, m, b["tokens"][c], b["labels"][c],
                                        float(tp["local_lr"]), seeds[c], quant)
            r.append(rc)
            ls.append(lv)
        losses.append(sum(ls) / n)
        rs.append(r)
        if k + 1 < int(tp["checked_rounds"]):
            tree = ref_close(tree, tags, r if follow is None else follow[k], seeds,
                             float(tp["server_lr"]))
    return {"losses": losses, "rs": rs}


def compare(prog: dict, ref: dict) -> dict:
    """Each round's mean loss, and each upload against its round's root mean
    square reference upload."""
    r_gap = 0.0
    for rp, rr in zip(prog["rs"], ref["rs"]):
        rp, rr = np.array(rp, np.float64), np.array(rr, np.float64)
        r_gap = max(r_gap, float(np.max(np.abs(rp - rr)) / np.sqrt(np.mean(rr ** 2))))
    return {"loss_rel_gap": max(abs(a - b) / abs(b)
                                for a, b in zip(prog["losses"], ref["losses"])),
            "r_gap": r_gap}


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
    checks = compare(prog, reference_rounds(run, like, batch, base, follow=prog["rs"]))
    checks["close_mismatch_share"] = close_mismatch(run, like, samples, prog["rs"], base)

    m = dense.dims(run.config)
    n = int(tp["clients"])
    total = sum(int(np.prod(s)) for s in shapes)
    views = [(int(np.prod(s[:-1])) if len(s) > 1 else 1, int(s[-1])) for s in shapes]
    return {
        "e2e": {"server_uploads_per_s": n * rounds / run.window_s,
                "peak_mem_gib": (run.peak_bytes or 0) / 2 ** 30,
                "setup_s": run.setup_s},
        "counters": {"rounds": rounds, "clients": n,
                     "encodes_per_round": n * int(tp["local_steps"]),
                     "encode_shapes": views, "decode_shapes": views,
                     "elem_bytes": torch.finfo(leaf_paths(like)[0][1].dtype).bits // 8,
                     "encode_kernels": list(ENCODE_KERNELS), "decode_kernel": DECODE_KERNEL,
                     "dtype": run.config["torch_dtype"], "seq_len": int(tp["seq_len"]),
                     "model": {"n_nonembed": total - m["vocab"] * m["d"] * (1 if m["tied"] else 2),
                               "d_model": m["d"], "vocab": m["vocab"], "layers": m["layers"],
                               "heads": m["h"], "head_dim": m["hd"]}},
        "checks": checks,
        "attempted": rounds,
        "failed": 0,
    }

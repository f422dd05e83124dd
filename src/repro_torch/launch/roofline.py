"""Roofline of every dry-run combination on H100s (port of
``repro/launch/roofline.py``).

The analytic layout model is the reference's, term for term: per (arch ×
shape × mesh × layout) the FLOPs, the HBM bytes and the link bytes of
one step per device, with explicit trip counts.  Only the rates are the
H100's in place of the TPU's:

* ``PEAK_FLOPS`` 989e12 FLOP/s: dense bf16 on the tensor cores of an
  H100 SXM (NVIDIA H100 datasheet; the figure ``chip_smoke.py``'s
  ``_flash_bound`` uses);
* ``HBM_BW`` 3.35e12 B/s: the H100 SXM's HBM3 (datasheet; ``chip_smoke.py``'s
  ``HBM_BYTES_PER_S``);
* ``NVLINK_BW`` 450e9 B/s: NVLink 4, 900 GB/s both ways, for an axis
  that stays inside one 8-GPU HGX node (datasheet);
* ``NDR_BW`` 50e9 B/s: one 400 Gb/s NDR InfiniBand port a GPU, for an
  axis across nodes (the HGX H100 reference design).

A mesh's collectives run at the slowest link they cross: a mesh of at
most ``GPUS_PER_NODE`` devices stays on NVLink, a larger one (the
reference's 256- and 512-device meshes) crosses nodes.  A mesh of one
device has no link: its collective term is zero.

The dry-run records (``launch/dryrun.py``) add what the meta pass
measured (FLOPs of the matrix products, peak live bytes); the analytic
terms stand on their own.
"""
from __future__ import annotations

import functools
import json
import os

from repro_torch.configs.registry import get_arch, get_config
from repro_torch.launch.mesh import PRODUCTION_MESHES
from repro_torch.models.api import INPUT_SHAPES, LONG_WINDOW
from repro_torch.sharding.rules import tree_paths

__all__ = ["PEAK_FLOPS", "HBM_BW", "NVLINK_BW", "NDR_BW", "GPUS_PER_NODE",
           "MESHES", "FL_CLIENTS", "FL_STEPS", "param_count", "expert_param_count",
           "active_param_count", "link_bw", "analytic_terms", "load_record",
           "full_table", "what_moves_it", "markdown_table"]

PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
NVLINK_BW = 450e9
NDR_BW = 50e9
GPUS_PER_NODE = 8

# The dry run's meshes as axis sizes (pod = 1 where there is no pod axis)
MESHES = {name: {"pod": 1, **dict(zip(axes, shape))}
          for name, (axes, shape) in PRODUCTION_MESHES.items()}

# FL round structure used by the train dry-run (launch/train.py)
FL_CLIENTS = 4
FL_STEPS = 2


@functools.lru_cache(maxsize=None)
def _leaf_shapes(arch_name: str) -> tuple:
    return tuple(tuple(leaf.shape) for _, leaf in
                 tree_paths(get_arch(arch_name).param_shapes()))


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def param_count(arch_name: str) -> int:
    return sum(_numel(s) for s in _leaf_shapes(arch_name))


def expert_param_count(arch_name: str) -> int:
    cfg = get_config(arch_name)
    if not cfg.num_experts:
        return 0
    return sum(_numel(s) for s in _leaf_shapes(arch_name)
               if len(s) >= 3 and cfg.num_experts in s)


def active_param_count(arch_name: str) -> int:
    cfg = get_config(arch_name)
    total = param_count(arch_name)
    ex = expert_param_count(arch_name)
    if not ex:
        return total
    return int(total - ex + ex * cfg.experts_per_token / cfg.num_experts)


def _attn_layers(cfg) -> int:
    return sum(1 for i in range(cfg.num_layers) if cfg.layer_kind(i) == "attn")


def link_bw(mesh: str) -> float | None:
    """The link rate a collective of ``mesh`` runs at; None for one device."""
    axes = MESHES[mesh]
    n = axes["pod"] * axes["data"] * axes["model"]
    if n == 1:
        return None
    return NVLINK_BW if n <= GPUS_PER_NODE else NDR_BW


def analytic_terms(arch_name: str, shape_name: str, mesh: str = "pod16x16",
                   layout: str = "zero3", global_batch: int | None = None,
                   clients: int = FL_CLIENTS, local_steps: int = FL_STEPS) -> dict:
    """Three roofline terms (seconds/step, per device) + components.

    ``global_batch`` cuts the shape's batch (the card's checks run
    ``train_4k`` at a cut batch); the default is the shape's.  A train
    round's ``clients`` × ``local_steps`` set its weight uses, gradient
    syncs and uplink (the reference's dry run: 4 × 2).
    """
    cfg = get_config(arch_name)
    seq, gb, mode = INPUT_SHAPES[shape_name]
    if global_batch is not None:
        gb = global_batch
    axes = MESHES[mesh]
    dp = axes["pod"] * axes["data"]
    mp = axes["model"]
    n_act = active_param_count(arch_name)
    n_tot = param_count(arch_name)
    w_bytes = 2 * n_tot                           # bf16 weights
    hd = cfg.resolved_head_dim
    h = cfg.num_heads
    l_attn = _attn_layers(cfg)
    dp_eff = max(1, min(dp, gb))                  # batch=1 cannot data-shard

    # ---------------- FLOPs ----------------
    if mode == "train":
        tokens = gb * seq
        kv_eff = seq / 2 if not cfg.window else min(cfg.window, seq)
        f_lin = 2.0 * n_act * tokens
        f_attn = 4.0 * l_attn * tokens * kv_eff * h * hd
        f_fwd = f_lin + f_attn
        flops_total = 4.0 * f_fwd                 # fwd + remat-recompute + 2×bwd
        weight_uses = clients * local_steps * 3   # fwd, recompute, bwd
    elif mode == "prefill":
        tokens = gb * seq
        kv_eff = seq / 2
        f_lin = 2.0 * n_act * tokens
        f_attn = 4.0 * l_attn * tokens * kv_eff * h * hd
        flops_total = f_lin + f_attn
        weight_uses = 1
    else:  # decode
        tokens = gb
        t_kv = min(seq, LONG_WINDOW) if (seq > 32768 and cfg.num_heads) else seq
        f_lin = 2.0 * n_act * tokens
        f_attn = 4.0 * l_attn * tokens * t_kv * h * hd
        flops_total = f_lin + f_attn
        weight_uses = 1

    # compute parallelism: zero3 = data-parallel compute only; tp adds model
    shards = dp_eff * (mp if layout == "tp" else 1)
    flops_dev = flops_total / shards

    # ---------------- HBM bytes ----------------
    tok_dev = tokens / dp_eff
    if layout == "zero3":
        weight_traffic = weight_uses * w_bytes            # gathered, read fully
    else:
        weight_traffic = weight_uses * w_bytes / mp       # each device reads its shard
    act_traffic = 8.0 * cfg.num_layers * tok_dev * cfg.d_model * 2 / (
        mp if layout == "tp" else 1)
    logits_traffic = 2.0 * tok_dev * cfg.vocab_size * 4 / (
        mp if layout == "tp" else 1)
    cache_traffic = 0.0
    if mode == "decode":
        t_kv = min(seq, LONG_WINDOW) if (seq > 32768 and cfg.num_heads) else seq
        kv_bytes = l_attn * 2 * t_kv * cfg.num_kv_heads * hd * 2
        mamba_layers = cfg.num_layers - l_attn
        ssm_bytes = mamba_layers * (cfg.d_inner * cfg.ssm_state * 4
                                    + cfg.ssm_conv * cfg.d_inner * 2) if cfg.ssm_state else 0
        cache_traffic = (kv_bytes + ssm_bytes) * gb / dp_eff / (
            mp if layout == "tp" else 1)
    if mode == "train":
        act_traffic *= 3.0                                # fwd + recompute + bwd
        logits_traffic *= 3.0
    bytes_dev = weight_traffic + act_traffic + logits_traffic + cache_traffic

    # ---------------- link bytes ----------------
    # Tokens are split across FL clients/local steps: each token makes one
    # fwd(+recompute+bwd) pass per round, so token-proportional traffic
    # carries no clients×steps factor; weight traffic does (weights are
    # re-fetched per client per step).
    passes = 3 if mode == "train" else 1
    if layout == "zero3":
        gather_bytes = weight_uses * w_bytes * (1 - 1.0 / (dp * mp))
    else:
        # tensor parallel: 2 all-reduces of the block output per layer pass
        gather_bytes = passes * 2.0 * cfg.num_layers * tok_dev * cfg.d_model * 2 * 2
    grad_sync = 0.0
    if mode == "train":
        # per local step each client's grad is data-parallel-averaged
        # (bf16 grads, ring factor 2)
        grad_sync = clients * local_steps * 2.0 * 2 * n_tot * (dp - 1) / dp
    moe_a2a = 0.0
    if cfg.num_experts:
        moe_layers = sum(1 for i in range(cfg.num_layers)
                         if cfg.ffn_kind(i) == "moe")
        moe_a2a = (passes * moe_layers * 2.0
                   * tok_dev * cfg.experts_per_token * cfg.d_model * 2)
    fedscalar_uplink = clients * 2 * 4 if mode == "train" else 0.0  # 2 scalars!
    ici_dev = gather_bytes + grad_sync + moe_a2a + fedscalar_uplink
    bw = link_bw(mesh)

    terms = {
        "compute_s": flops_dev / PEAK_FLOPS,
        "memory_s": bytes_dev / HBM_BW,
        "collective_s": 0.0 if bw is None else ici_dev / bw,
    }
    dominant = max(terms, key=terms.get)
    return {
        **terms,
        "dominant": dominant.replace("_s", ""),
        "bound_s": terms[dominant],
        "roofline_fraction": terms[dominant] / sum(terms.values()),
        "model_flops": (6.0 if mode == "train" else 2.0) * n_act * tokens,
        "flops_total": flops_total,
        "useful_flop_ratio": ((6.0 if mode == "train" else 2.0) * n_act * tokens)
                             / flops_total,
        "components": {
            "weight_traffic_gb": weight_traffic / 1e9,
            "act_traffic_gb": act_traffic / 1e9,
            "cache_traffic_gb": cache_traffic / 1e9,
            "gather_ici_gb": gather_bytes / 1e9,
            "grad_sync_ici_gb": grad_sync / 1e9,
            "moe_a2a_ici_gb": moe_a2a / 1e9,
            "fedscalar_uplink_bytes": fedscalar_uplink,
        },
        "layout": layout,
        "link_bw": bw,
    }


def load_record(arch: str, shape: str, mesh: str = "pod16x16",
                outdir: str = "experiments/dryrun_torch"):
    path = os.path.join(outdir, f"{arch}__{shape}__{mesh}.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def full_table(mesh: str = "pod16x16", layout: str = "zero3",
               outdir: str = "experiments/dryrun_torch"):
    from repro_torch.configs.registry import ARCH_IDS
    rows = []
    for arch in ARCH_IDS:
        for shape in INPUT_SHAPES:
            rec = load_record(arch, shape, mesh, outdir)
            row = {"arch": arch, "shape": shape, "mesh": mesh,
                   "compiled": bool(rec and rec.get("ok"))}
            row.update(analytic_terms(arch, shape, mesh, layout))
            if rec and rec.get("ok"):
                pd = rec["per_device"]
                row["meta_flops"] = pd["flops"]
                row["peak_gib_dev"] = pd["peak_bytes_est"] / 2**30
            rows.append(row)
    return rows


def what_moves_it(row: dict) -> str:
    d = row["dominant"]
    c = row["components"]
    if d == "compute":
        return ("compute-bound — already near the useful-FLOP limit; gains "
                "come from cutting remat recompute or capacity-factor waste")
    if d == "memory":
        if c["weight_traffic_gb"] > c["act_traffic_gb"] + c["cache_traffic_gb"]:
            return ("HBM-bound on gathered-weight reads — switch the layer "
                    "loop to tensor-parallel (weights stay sharded) or batch "
                    "more tokens per weight fetch")
        if c["cache_traffic_gb"] > 0:
            return ("HBM-bound on KV-cache reads — shard the cache over "
                    "model (head_dim) and keep it bf16; window caps help")
        return "HBM-bound on activations — fuse elementwise chains, bf16 boundaries"
    if c["gather_ici_gb"] > c["grad_sync_ici_gb"] + c["moe_a2a_ici_gb"]:
        return ("collective-bound on ZeRO-3 weight all-gathers — move to "
                "tensor-parallel layout (no per-layer gathers)")
    if c["moe_a2a_ici_gb"] > c["grad_sync_ici_gb"]:
        return ("collective-bound on MoE all-to-all — shard experts deeper / "
                "route within pods first (hierarchical a2a)")
    return ("collective-bound on per-step gradient all-reduce — overlap with "
            "backward or reduce local-step sync (FedScalar's own lever: more "
            "local steps per round)")


def markdown_table(rows) -> str:
    hdr = ("| arch | shape | compute s | memory s | collective s | bound "
           "| frac | useful/meta | dry run |\n|---|---|---|---|---|---|---|---|---|")
    out = [hdr]
    for r in rows:
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['compute_s']:.3g} | "
            f"{r['memory_s']:.3g} | {r['collective_s']:.3g} | "
            f"**{r['dominant']}** | {r['roofline_fraction']:.0%} | "
            f"{r['useful_flop_ratio']:.2f} | "
            f"{'ok' if r.get('compiled') else '—'} |")
    return "\n".join(out)


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="pod16x16", choices=list(MESHES))
    ap.add_argument("--layout", default="zero3", choices=["zero3", "tp"])
    a = ap.parse_args()
    rows = full_table(mesh=a.mesh, layout=a.layout)
    print(markdown_table(rows))
    print()
    for r in rows:
        print(f"{r['arch']:22s} {r['shape']:12s} → {what_moves_it(r)}")

"""Federated simulation (torch port of ``repro/fed/simulation.py``).

Runs one method for K rounds: per round each client samples a fresh
minibatch per local step from its own shard, the method's round runs
(:func:`repro_torch.core.fedscalar.fedscalar_round`: kernel encode and
fused kernel close; :func:`repro_torch.core.fedavg.fedavg_round`;
:func:`repro_torch.core.qsgd.qsgd_round`: the QSGD kernel), and the
global model's loss and accuracy on the test set are recorded.  The bandwidth / energy cost model (eqs. 12–13)
is applied afterwards from the per-round upload payloads.

Batches are drawn with a ``torch.Generator`` seeded from ``cfg.seed``;
it cannot reproduce the reference's ``jax.random`` draws, so parity with
the reference is checked round by round on explicit batches.  The
history has the reference's keys; ``sim_compile_seconds`` is the first
round (kernel build and load included) and ``sim_compute_seconds`` the
rest.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np
import torch

from repro_torch.core import fedavg as fa
from repro_torch.core import fedscalar as fs
from repro_torch.core import qsgd as q
from repro_torch.core.prng import Distribution
from repro_torch.core.projection import ProjectionMode, tree_size
from repro_torch.core.tree import tree_map
from repro_torch.device import resolve_device
from repro_torch.fed.costmodel import ChannelConfig, CostModel, dense_upload_bits
from repro_torch.models.mlp_classifier import mlp_accuracy, mlp_grad, mlp_loss

__all__ = ["SimulationConfig", "run_simulation", "METHODS",
           "METHOD_FOR_DISTRIBUTION", "protocol_config"]

METHODS = (
    "fedscalar_rademacher",
    "fedscalar_gaussian",
    "fedavg",
    "qsgd",
    "fedscalar_m8",
    "fedscalar_block8",
    "fedscalar_ef",
    "fedscalar_sparse",
    "fedscalar_hadamard",
)

# run_simulation method of each direction family at k = 1: the federation
# runtime's full-participation shortcut keys on it.
METHOD_FOR_DISTRIBUTION = {
    Distribution.RADEMACHER: "fedscalar_rademacher",
    Distribution.GAUSSIAN: "fedscalar_gaussian",
    Distribution.SPARSE_RADEMACHER: "fedscalar_sparse",
    Distribution.HADAMARD: "fedscalar_hadamard",
}


@dataclasses.dataclass(frozen=True)
class SimulationConfig:
    method: str = "fedscalar_rademacher"
    rounds: int = 1500              # K
    num_clients: int = 20           # N
    local_steps: int = 5            # S
    batch_size: int = 32
    local_lr: float = 3e-3          # α
    seed: int = 0
    channel: ChannelConfig = dataclasses.field(default_factory=ChannelConfig)
    capture_uploads: bool = False


def protocol_config(cfg: SimulationConfig):
    """The config behind a method: FedScalarConfig, FedAvgConfig or QSGDConfig."""
    m = cfg.method
    base = dict(local_steps=cfg.local_steps, local_lr=cfg.local_lr)
    if m == "fedavg":
        return fa.FedAvgConfig(**base)
    if m == "qsgd":
        return q.QSGDConfig(**base)
    if m == "fedscalar_rademacher":
        return fs.FedScalarConfig(**base)
    if m == "fedscalar_gaussian":
        return fs.FedScalarConfig(distribution=Distribution.GAUSSIAN, **base)
    if m == "fedscalar_sparse":
        return fs.FedScalarConfig(distribution=Distribution.SPARSE_RADEMACHER,
                                  **base)
    if m == "fedscalar_hadamard":
        return fs.FedScalarConfig(distribution=Distribution.HADAMARD, **base)
    if m == "fedscalar_m8":
        return fs.FedScalarConfig(num_projections=8, **base)
    if m == "fedscalar_block8":
        return fs.FedScalarConfig(num_projections=8, mode=ProjectionMode.BLOCK,
                                  **base)
    if m == "fedscalar_ef":
        # contractive compressor → tiny raw steps; server_lr rescales
        return fs.FedScalarConfig(error_feedback=True, server_lr=32.0, **base)
    raise ValueError(f"unknown method {m!r}")


def _stack_clients(client_sets):
    """Pad every client's shard to a common length by cycling."""
    n_max = max(x.shape[0] for x, _ in client_sets)
    xs, ys = [], []
    for x, y in client_sets:
        reps = int(np.ceil(n_max / x.shape[0]))
        xs.append(np.tile(x, (reps, 1))[:n_max])
        ys.append(np.tile(y, reps)[:n_max])
    return np.stack(xs), np.stack(ys)


def run_simulation(cfg: SimulationConfig, init_params: Any, client_sets,
                   x_test: np.ndarray, y_test: np.ndarray,
                   device="cuda") -> dict:
    """Run one method for K rounds on ``device`` → history dict of numpy arrays."""
    dev = resolve_device(device)
    pc = protocol_config(cfg)
    fedscalar = isinstance(pc, fs.FedScalarConfig)
    if cfg.capture_uploads and not fedscalar:
        raise ValueError(
            f"capture_uploads needs a fedscalar method (uploads are (r, ξ) "
            f"scalars); {cfg.method!r} frames are Θ(d)")
    if fedscalar:
        bits_per_client = fs.upload_bits_per_client(init_params, pc)
    elif cfg.method == "fedavg":
        bits_per_client = fa.upload_bits_per_client(init_params, pc)
    else:
        bits_per_client = q.upload_bits_per_client(init_params, pc)

    cx_np, cy_np = _stack_clients(client_sets)
    cx = torch.from_numpy(cx_np).to(dev, torch.float32)   # (N, n_per, 64)
    cy = torch.from_numpy(cy_np.astype(np.int64)).to(dev)  # (N, n_per)
    n, n_per = cy.shape
    if n != cfg.num_clients:
        raise ValueError(f"{n} client shards for num_clients={cfg.num_clients}")
    xt = torch.from_numpy(np.asarray(x_test, np.float32)).to(dev)
    yt = torch.from_numpy(np.asarray(y_test).astype(np.int64)).to(dev)
    S, B = cfg.local_steps, cfg.batch_size
    gen = torch.Generator().manual_seed(cfg.seed)
    rows = torch.arange(n, device=dev)[:, None]

    params = tree_map(lambda p: p.to(dev), init_params)
    ef = None
    if fedscalar and pc.error_feedback:
        ef = tree_map(lambda p: torch.zeros((n,) + tuple(p.shape),
                                            dtype=torch.float32, device=dev),
                      params)
    losses, accs, r_hist, seed_hist = [], [], [], []
    t_first = time.perf_counter()
    t_rest = None
    with torch.no_grad():
        for k in range(cfg.rounds):
            if k == 1:
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                t_rest = time.perf_counter()
            idx = torch.randint(0, n_per, (n, S * B), generator=gen).to(dev)
            bx = cx[rows, idx].reshape(n, S, B, -1)
            by = cy[rows, idx].reshape(n, S, B)
            if fedscalar:
                params, (aux, ef) = fs.fedscalar_round(params, (bx, by), k,
                                                       mlp_grad, pc, ef)
            elif cfg.method == "fedavg":
                params, _ = fa.fedavg_round(params, (bx, by), k, mlp_grad, pc)
            else:
                params, _ = q.qsgd_round(params, (bx, by), k, mlp_grad, pc)
            losses.append(mlp_loss(params, (xt, yt)))
            accs.append(mlp_accuracy(params, xt, yt))
            if cfg.capture_uploads:
                r_hist.append(aux["r"])
                seed_hist.append(aux["seeds"])
    losses_np = torch.stack(losses).cpu().numpy()   # waits for the device
    accs_np = torch.stack(accs).cpu().numpy()
    t_end = time.perf_counter()
    compile_s = (t_rest or t_end) - t_first
    compute_s = t_end - t_rest if t_rest is not None else 0.0

    cm = CostModel(dataclasses.replace(cfg.channel, num_clients=cfg.num_clients),
                   fedavg_bits_per_client=dense_upload_bits(tree_size(init_params)),
                   rng_seed=cfg.seed)
    bits = np.zeros(cfg.rounds)
    wall = np.zeros(cfg.rounds)
    energy = np.zeros(cfg.rounds)
    for k in range(cfg.rounds):
        bits[k], wall[k], energy[k] = cm.round_cost(bits_per_client)

    return dict(
        method=cfg.method,
        round=np.arange(1, cfg.rounds + 1),
        loss=losses_np,
        accuracy=accs_np,
        r_history=(torch.stack(r_hist).cpu().numpy() if cfg.capture_uploads
                   else None),
        seed_history=(torch.stack(seed_hist).cpu().numpy().astype(np.uint32)
                      if cfg.capture_uploads else None),
        cum_bits=np.cumsum(bits),
        cum_wall_s=np.cumsum(wall),
        cum_energy_j=np.cumsum(energy),
        bits_per_client_per_round=bits_per_client,
        final_params=params,
        sim_compile_seconds=compile_s,
        sim_compute_seconds=compute_s,
    )

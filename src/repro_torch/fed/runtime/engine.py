"""Round driver: K server rounds over populations up to ~10⁵ clients.

Torch port of ``repro/fed/runtime/engine.py``.  Every registered
:class:`repro_torch.fed.protocols.UplinkProtocol` — ``fedscalar``,
``fedavg`` and ``qsgd`` — runs through the same cohort sampler, channel,
streaming server and cost model.  Per round the engine

  1. samples a cohort (:mod:`sampling`, numpy: the reference's cohorts),
  2. serves the downlink: the dense model broadcast, or under ``digest``
     (fedscalar only) each sampled client's catch-up from the round log,
  3. runs the cohort's S local-SGD steps in chunks of ``client_chunk``
     clients (one batched autograd computation per chunk) and lets the
     protocol encode the chunk: fedscalar through the projection kernel,
     qsgd through the QSGD kernel,
  4. pushes every frame through the protocol's byte-level wire codec and
     the lossy, laggy channel (:mod:`transport`),
  5. closes the round in the streaming aggregator (:mod:`server`) and
     applies the survivors.  For fedscalar the apply is the plain
     per-client loop, the per-client decode kernel
     (``seeded_reconstruct.cu``) once the cohort reaches
     ``kernel_cohort_threshold``, the fused close kernel
     (``reconstruct_apply.cu``) under ``projection_mode="fused_kernel"``,
     or, with ``mesh_shape`` set, the mesh-sharded decode
     (:mod:`repro_torch.sharding.fed_rules`: each device's shards of the
     tree in one launch of the per-client decode kernel), which takes
     precedence; for the dense protocols it is the (weighted) frame mean,
  6. in digest mode broadcasts the round's :class:`RoundDigest`; with
     ``verify_replay`` a shadow :class:`StatefulClient` replays it
     through the same apply and must land on the same bits,
  7. charges the round to the two-sided cost model (eqs. 12′/13′).

The reference's ``jax.jit`` stages are plain functions here.  A fully
participating, synchronous, lossless fp32 configuration delegates to
:func:`repro_torch.fed.simulation.run_simulation`, as the reference does.
With ``scheduler=`` the continuous-round driver
(:mod:`repro_torch.fed.runtime.scheduler`) runs the rounds instead (sync
bit-identical to the legacy loop, or async pipelined) and the fused
shortcut is never taken.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import TYPE_CHECKING, Any, Callable

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import fedscalar as fs
from repro_torch.core.prng import Distribution, U32_MASK
from repro_torch.core.projection import tree_size, view2d
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.device import resolve_device
from repro_torch.fed.costmodel import ChannelConfig, CostModel
from repro_torch.fed.runtime.sampling import (
    ClientPopulation,
    CohortSampler,
    sampling_diagnostic,
)
from repro_torch.fed.runtime.server import ServerConfig, StreamingAggregator, Upload
from repro_torch.fed.runtime.transport import (
    DownlinkChannel,
    RoundDigest,
    RoundLog,
    UplinkChannel,
    WireFormat,
)

if TYPE_CHECKING:
    from repro_torch.fed.runtime.scheduler import SchedulerConfig

__all__ = ["RuntimeConfig", "EngineCore", "run_federation",
           "draw_cohort_batches", "StatefulClient"]

@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    """Everything the federation runtime needs for one K-round run."""

    rounds: int = 50                    # K
    population: int = 1000              # registered clients
    participation: float = 0.01         # expected sampled fraction per round
    sampler: str = "uniform"            # uniform | weighted | poisson
    protocol_name: str = "fedscalar"    # fedscalar | fedavg | qsgd
    local_steps: int = 5                # S
    batch_size: int = 32
    local_lr: float = 3e-3              # α
    server_lr: float = 1.0
    distribution: Distribution = Distribution.RADEMACHER
    family: str | None = None           # direction family name; overrides
                                        # `distribution` when set
    num_projections: int = 1            # k scalars per upload
    projection_mode: str = "full"       # "full", "block", or "fused_kernel":
                                        # block semantics (full at k=1) closed
                                        # by the fused kernel (fedscalar only)
    qsgd_bits: int = 8                  # level-code width of the qsgd protocol
    seed: int = 0
    scalar_format: str = "fp32"         # wire width of r (fp32 | fp16 | bf16)
    eval_every: int = 1
    client_chunk: int = 256             # cohort members per compute chunk
    kernel_cohort_threshold: int | None = None  # cohorts ≥ this → per-client
                                                # decode kernel (None: 512 on
                                                # a CUDA device, never on the
                                                # CPU; fedscalar only)
    mesh_shape: tuple | None = None     # (data, model) mesh of the sharded
                                        # server apply (fedscalar only); a
                                        # port mesh may hold more shards
                                        # than cards
    downlink_mode: str = "dense"        # "dense" or "digest" (fedscalar only)
    downlink_log_window: int = 64       # digest mode: rounds of catch-up log
    verify_replay: bool = False         # digest mode: shadow-client replay
                                        # must equal the server bit for bit
    server: ServerConfig = dataclasses.field(default_factory=ServerConfig)
    channel: ChannelConfig = dataclasses.field(default_factory=ChannelConfig)
    scheduler: SchedulerConfig | None = None     # continuous-round driver
                                        # (None: the legacy loop)

    def resolved_distribution(self) -> Distribution:
        if self.family is not None:
            from repro_torch.core.directions import get_family
            return get_family(self.family).distribution
        return self.distribution

    def resolved_projection_mode(self):
        """→ the ProjectionMode behind the config string (``fused_kernel``
        is a routing choice: block scalars, plain FULL at k = 1)."""
        from repro_torch.core.projection import ProjectionMode
        if self.projection_mode == "fused_kernel":
            return (ProjectionMode.BLOCK if self.num_projections > 1
                    else ProjectionMode.FULL)
        return ProjectionMode(self.projection_mode)

    def protocol(self) -> fs.FedScalarConfig:
        return fs.FedScalarConfig(
            local_steps=self.local_steps, local_lr=self.local_lr,
            server_lr=self.server_lr,
            distribution=self.resolved_distribution(),
            num_projections=self.num_projections,
            mode=self.resolved_projection_mode())

    def wire(self) -> WireFormat:
        return WireFormat(scalar=self.scalar_format,
                          num_projections=self.num_projections)

    def build_protocol(self, params_like):
        """→ the configured :class:`repro_torch.fed.protocols.UplinkProtocol`."""
        from repro_torch.core import fedavg as fa
        from repro_torch.core import qsgd as q
        from repro_torch.fed.protocols import make_protocol

        base = dict(local_steps=self.local_steps, local_lr=self.local_lr,
                    server_lr=self.server_lr)
        return make_protocol(
            self.protocol_name, params_like,
            fedscalar_config=self.protocol(), wire_format=self.wire(),
            fedavg_config=fa.FedAvgConfig(**base),
            scalar_format=self.scalar_format,
            qsgd_config=q.QSGDConfig(bits=self.qsgd_bits, **base))

    def cohort_size(self) -> int:
        return max(1, int(round(self.participation * self.population)))


def _batch_stream_seed(seed: int, round_idx: int, client_id: int) -> int:
    """64-bit seed of one (run, round, client) batch stream (SplitMix64 mix)."""
    mask = (1 << 64) - 1
    x = 0
    for v in (seed, round_idx, client_id):
        x = (x ^ (int(v) & mask)) * 0x9E3779B97F4A7C15 & mask
        x ^= x >> 31
    return x & ((1 << 63) - 1)


def draw_cohort_batches(cx, cy, num_shards: int, seed: int, round_idx,
                        client_ids, local_steps: int, batch_size: int):
    """Per-(round, client) minibatch streams for a cohort.

    ``cx``/``cy`` are the stacked client shards ``(#shards, n_per, ...)``;
    client n reads shard n mod #shards.  Each client's indices come from a
    ``torch.Generator`` seeded from (run seed, round, client id), so the
    stream is a pure function of those three values and independent of
    the cohort's makeup, as the reference's is.  It is **not** the
    reference's stream: that one is ``jax.random`` threefry, which the
    port does not reproduce; parity tests patch this function in both
    packages with one shared index table.

    → ``(bx, by)`` with shapes ``(C, S, B, feat...)`` / ``(C, S, B)``.
    """
    n_per = cx.shape[1]
    S, B = local_steps, batch_size
    ids = [int(i) for i in client_ids.tolist()]
    idx = torch.stack([
        torch.randint(0, n_per, (S * B,), generator=torch.Generator().manual_seed(
            _batch_stream_seed(seed, int(round_idx), cid)))
        for cid in ids]).to(cx.device)
    shard = torch.as_tensor([cid % num_shards for cid in ids],
                            dtype=torch.int64, device=cx.device)
    rows = shard[:, None]
    bx = cx[rows, idx].reshape((len(ids), S, B) + tuple(cx.shape[2:]))
    by = cy[rows, idx].reshape(len(ids), S, B)
    return bx, by


def _fused_method(cfg: RuntimeConfig, num_shards: int) -> str | None:
    """→ the ``run_simulation`` method iff the config degenerates to it."""
    from repro_torch.fed.simulation import METHOD_FOR_DISTRIBUTION

    base = (
        cfg.participation == 1.0
        and cfg.sampler in ("uniform", "weighted")
        and cfg.mesh_shape is None
        and cfg.population == num_shards
        and not math.isfinite(cfg.server.deadline_s)
        and cfg.server.max_staleness == 0
        and cfg.channel.drop_prob == 0.0
        and cfg.channel.base_latency_s == 0.0
        and cfg.scalar_format == "fp32"
        and cfg.server_lr == 1.0
        and cfg.projection_mode != "fused_kernel"
    )
    if not base:
        return None
    if cfg.protocol_name == "fedavg":
        return "fedavg"
    if cfg.protocol_name == "qsgd":
        return "qsgd" if cfg.qsgd_bits == 8 else None
    if (cfg.num_projections == 1
            and cfg.resolved_distribution() in METHOD_FOR_DISTRIBUTION):
        return METHOD_FOR_DISTRIBUTION[cfg.resolved_distribution()]
    return None


def _pad_pow2(n: int, lo: int = 16) -> int:
    """Bucket size for round-close buffers (the reference's recompilation
    bound; kept on every route but the per-client decode kernel's on the
    card)."""
    b = lo
    while b < n:
        b *= 2
    return b


def _pad_bucket(ars: np.ndarray, acoeffs: np.ndarray,
                aseeds: np.ndarray | None = None):
    """Zero-pad the round-close buffers to a power-of-two bucket.

    Zero weights give zero contributions.  → ``(rs_b, w_b)`` or
    ``(rs_b, w_b, seeds_b)`` when seeds are given.  The per-client decode
    kernel's route on the card stages the applied rows alone
    (:func:`_stage_weighted`).
    """
    a = len(acoeffs)
    bucket = _pad_pow2(a)
    rs_b = np.zeros((bucket, ars.shape[1]), np.float32)
    rs_b[:a] = ars
    w_b = np.zeros(bucket, np.float32)
    w_b[:a] = acoeffs.astype(np.float32)
    if aseeds is None:
        return rs_b, w_b
    seeds_b = np.zeros(bucket, np.uint32)
    seeds_b[:a] = aseeds
    return rs_b, w_b, seeds_b


# Devices on which the per-client decode kernel's route stages the applied
# rows alone.  The CPU runs the kernel's plain version on that route, with
# the reference's bucket: the benchmark's CPU run of its server cell
# (``fedbench/test_fedbench_spans.py``) holds it to the padded slot count.
_APPLIED_ROWS_DEVICES = ("cuda",)


def _stage_weighted(device, ars: np.ndarray, acoeffs: np.ndarray,
                    aseeds: np.ndarray, decode_kernel: bool):
    """A weighted FedScalar round's buffers on ``device`` → ``(rs, w, seeds)``.

    For the per-client decode kernel on the card (``decode_kernel``), the
    applied uploads alone, in :func:`_pad_bucket`'s dtypes: the kernel adds
    the rows in order to a float32 accumulator that starts at +0, and the
    bucket's zero rows at the tail would each add ±0, so the applied rows
    give the padded launch's bits without decoding the padding.  Otherwise
    the bucket.
    """
    if decode_kernel and device.type in _APPLIED_ROWS_DEVICES:
        bufs = (np.asarray(ars, np.float32), np.asarray(acoeffs).astype(np.float32),
                np.asarray(aseeds).astype(np.uint32))
    else:
        bufs = _pad_bucket(ars, acoeffs, aseeds)
    return _dev_tensors(device, *bufs)


def _dev_tensors(device, *arrays):
    """numpy arrays → tensors on ``device`` (uint32 seeds → int64 words)."""
    out = []
    for a in arrays:
        a = np.asarray(a)
        if a.dtype == np.uint32:
            a = a.astype(np.int64)
        out.append(torch.from_numpy(np.ascontiguousarray(a)).to(device))
    return out


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class StatefulClient:
    """Client-side downlink state: holds x_j, advances by digest replay.

    A client keeps its last synced parameters and replays each
    :class:`RoundDigest` through the same apply the server ran (the
    weighted apply for event-driven rounds, staged as the server stages
    it, by :func:`_stage_weighted`; the exact uniform mean for
    full-arrival rounds).  The digest carries exactly the server's
    (seeds, coefficients, scalars), so the replayed
    parameters are bit-identical when both sides pin the same apply
    method: ``use_kernel`` is False/"fori", True/"kernel" (the per-client
    decode kernel) or "fused" (the fused close kernel).  The port's
    ``run_simulation`` closes with the fused kernel, so a replay of its
    uniform-mean rounds passes ``"fused"``.
    """

    def __init__(self, params: Any, protocol, start_round: int = 0):
        if "digest" not in protocol.downlink_modes:
            raise ValueError(f"protocol {protocol.name!r} has no digest "
                             "downlink to replay")
        self.params = params
        self.next_round = start_round
        self.protocol = protocol

    def _apply(self, rs, seeds, weights, use_kernel):
        kw = {}
        if use_kernel == "fused":
            kw = dict(use_fused=True)
        elif use_kernel in (True, "kernel"):
            kw = dict(use_kernel=True)
        return self.protocol.server_apply(self.params, rs, seeds, weights, **kw)

    def apply_digest(self, dg: RoundDigest,
                     use_kernel: bool | str = False) -> Any:
        """Replay one round's digest → the post-round parameters."""
        if dg.round_idx != self.next_round:
            raise ValueError(f"client holds x_{self.next_round}, cannot "
                             f"apply digest of round {dg.round_idx}")
        self.next_round += 1
        if dg.num_uploads == 0:        # skipped / empty round: no-op
            return self.params
        dev = tree_leaves(self.params)[0].device
        if dg.uniform_mean:
            rs, seeds = _dev_tensors(dev, dg.rs, dg.seeds)
            self.params = self._apply(rs, seeds, None, use_kernel)
        else:
            rs, w, seeds = _stage_weighted(dev, dg.rs, dg.coeffs, dg.seeds,
                                           use_kernel in (True, "kernel"))
            self.params = self._apply(rs, seeds, w, use_kernel)
        return self.params

    def catch_up(self, log: RoundLog, server_params: Any = None,
                 use_kernel: bool | str = False) -> dict:
        """Sync to the log head: replay the suffix, or dense-resync past
        the window (``server_params`` required).
        → ``dict(mode, rounds_replayed, suffix_bits)``."""
        bits = log.suffix_bits(self.next_round)
        if bits is None:
            if server_params is None:
                raise ValueError(
                    f"gap {log.next_round - self.next_round} exceeds the "
                    f"{log.window}-round log window: dense resync needs "
                    "server_params")
            self.params = server_params
            self.next_round = log.next_round
            return dict(mode="dense", rounds_replayed=0, suffix_bits=0)
        frames = log.replay(self.next_round)
        for dg in frames:
            self.apply_digest(dg, use_kernel=use_kernel)
        return dict(mode="digest" if frames else "current",
                    rounds_replayed=len(frames), suffix_bits=bits)


class EngineCore:
    """One run's stages and channel state: data, sampler, cost model,
    channels, aggregator, the compute/apply/eval stages and the
    per-client downlink state.  Construction draws nothing from the cost
    model's RNG, so the draw sequence is the reference's."""

    def __init__(self, cfg: RuntimeConfig, init_params: Any, client_sets,
                 x_test, y_test, grad_fn: Callable, eval_fns, client_weights,
                 proto, d: int, device):
        from repro_torch.fed.simulation import _stack_clients

        loss_fn, acc_fn = eval_fns
        self.cfg = cfg
        self.proto = proto
        self.codec = proto.wire_codec
        self.d = d
        self.device = device
        num_shards = len(client_sets)
        self.num_shards = num_shards
        cx_np, cy_np = _stack_clients(client_sets)
        self.cx = torch.from_numpy(np.asarray(cx_np, np.float32)).to(device)
        self.cy = torch.from_numpy(cy_np.astype(np.int64)).to(device)
        self.xt = torch.from_numpy(np.asarray(x_test, np.float32)).to(device)
        self.yt = torch.from_numpy(np.asarray(y_test).astype(np.int64)).to(device)

        if client_weights is None and cfg.sampler == "weighted":
            shard_sizes = np.asarray([len(y) for _, y in client_sets], np.float64)
            client_weights = shard_sizes[np.arange(cfg.population) % num_shards]
        population = ClientPopulation(cfg.population, weights=client_weights)
        self.sampler = CohortSampler(population, cfg.participation,
                                     cfg.sampler, seed=cfg.seed)
        self.cm = CostModel(
            cfg.channel, fedavg_bits_per_client=d * cfg.channel.float_bits,
            rng_seed=cfg.seed)
        self.uplink = UplinkChannel(self.cm, self.codec)
        self.digest_mode = cfg.downlink_mode == "digest"
        self.downlink = DownlinkChannel(
            self.cm, d, cfg.channel.float_bits, mode=cfg.downlink_mode,
            digest_codec=proto.digest_codec() if self.digest_mode else None,
            log_window=cfg.downlink_log_window)
        # One int32 round index per client is the whole per-client state.
        self.client_last = (np.zeros(cfg.population, np.int32)
                            if self.digest_mode else None)
        self.shadow = (StatefulClient(init_params, proto)
                       if cfg.verify_replay else None)
        self.agg = StreamingAggregator(cfg.server)
        self.local = fs.make_local_sgd(grad_fn, cfg.local_lr, cfg.local_steps)
        self.loss_fn, self.acc_fn = loss_fn, acc_fn

        kern_thresh = cfg.kernel_cohort_threshold
        if kern_thresh is None:
            kern_thresh = 512 if device.type == "cuda" else None
        self.kern_thresh = kern_thresh

        # The fused close (projection_mode="fused_kernel") reads the tuning
        # cache once, read-only, for the dominant leaf's 2-D view: a miss
        # means the defaults.  Both knobs are bits-invariant, so tuned and
        # untuned applies agree to the bit.
        self.fused_params = None
        if cfg.projection_mode == "fused_kernel" and proto.name == "fedscalar":
            from repro_torch.kernels.tune import cached_fused_params

            lead = max(tree_leaves(init_params), key=lambda x: x.numel(),
                       default=None)
            if lead is not None and lead.dim():
                rows, cols = view2d(tuple(lead.shape))
                self.fused_params = cached_fused_params(
                    rows, cols, cfg.cohort_size(), cfg.num_projections,
                    cfg.resolved_distribution().value,
                    dtype_bits=torch.finfo(lead.dtype).bits, device=device)

        # The mesh-sharded apply: each device decodes its shards of the
        # tree.  Params stay replicated (the client chunks and eval read the
        # full model every round), so each apply shards and unshards the
        # views; a decode-only server holding x resident calls
        # fed_rules.sharded_apply_blocks and skips that round trip.
        self.mesh = None
        self.shard_info = None
        if cfg.mesh_shape is not None:
            from repro_torch.launch.mesh import make_fed_mesh
            from repro_torch.sharding.fed_rules import num_mesh_shards, plan_tree

            self.mesh = make_fed_mesh(tuple(cfg.mesh_shape), device=device)
            plan = plan_tree(init_params, num_mesh_shards(self.mesh))
            self.shard_info = dict(
                mesh_shape=tuple(cfg.mesh_shape),
                devices=num_mesh_shards(self.mesh),
                per_device_elements=plan.per_shard_elements(),
                balance=plan.balance(),
            )

    # ---- driver stages ----

    def chunk_payloads(self, params, round_idx: int, client_ids: torch.Tensor):
        """One chunk of clients' local rounds → (payloads, seeds).

        ``draw_cohort_batches`` is looked up in this module at call time,
        so a test can patch it.
        """
        cfg = self.cfg
        bx, by = draw_cohort_batches(self.cx, self.cy, self.num_shards,
                                     cfg.seed, round_idx, client_ids,
                                     cfg.local_steps, cfg.batch_size)
        seeds = fs.round_seeds_for(round_idx, client_ids, device=self.device)
        deltas = self.local(params, (bx, by))
        payloads = self.proto.encode_cohort(deltas, seeds, round_idx,
                                            client_ids)
        return payloads, seeds

    def compute_cohort(self, params, k: int, ids: np.ndarray):
        """The cohort's local rounds in chunks of ``client_chunk``
        → (float32 (C, payload_dim) payloads, uint32 (C,) seeds)."""
        c = len(ids)
        rs_np = np.zeros((max(c, 1), self.proto.payload_dim), np.float32)
        seeds_np = np.zeros(max(c, 1), np.uint32)
        chunk = self.cfg.client_chunk
        for lo in range(0, c, chunk):
            part = torch.as_tensor(np.asarray(ids[lo:lo + chunk], np.int64),
                                   device=self.device)
            rs_c, seeds_c = self.chunk_payloads(params, k, part)
            rs_np[lo:lo + len(part)] = rs_c.cpu().numpy()
            seeds_np[lo:lo + len(part)] = (seeds_c.cpu().numpy()
                                           & U32_MASK).astype(np.uint32)
        return rs_np, seeds_np

    def offer_uploads(self, ids, weights, k: int, tx,
                      deadline_s: float | None = None) -> None:
        """Offer one round's transmitted cohort to the aggregator, in
        client-id order (the deterministic aggregation order)."""
        with obs.span("server.offer"):
            for i in range(len(ids)):
                self.agg.offer(Upload(
                    client_id=int(ids[i]), encoded_round=k,
                    seed=int(tx.seeds[i]), r=tx.r_hat[i],
                    agg_weight=float(weights[i]),
                    latency_s=float(tx.latency_s[i]), lost=bool(tx.lost[i])),
                    deadline_s=deadline_s)

    def apply_round(self, params, aseeds, acoeffs, ars, cohort_size: int, st):
        """Fold a closed round's buffers into the model.

        → ``(params, method, apply_s)``; ``method`` ("fused", True for the
        per-client decode kernel, False for the plain loop) is what the
        digest replay must pin.  ``apply_s`` is read after a device
        synchronise.  A mesh round pins the decode kernel: the sharded
        decode is the unsharded decode kernel bit for bit (reconstruction
        is elementwise), whereas the reference pins its plain loop, which
        its own mesh mirror equals.  The decode kernel's route off a mesh
        stages the applied rows alone on the card (:func:`_stage_weighted`:
        the same bits, no padding decoded); every other route keeps the
        bucket.
        """
        a = len(aseeds)
        use_kernel: bool | str = False
        apply_s = 0.0
        dev = self.device
        if a and not st.skipped:
            t_apply = time.perf_counter()
            if self.proto.name == "fedscalar":
                if self.mesh is not None:
                    use_kernel = True
                elif self.cfg.projection_mode == "fused_kernel":
                    use_kernel = "fused"
                elif (self.kern_thresh is not None
                        and a >= self.kern_thresh
                        and (self.cfg.num_projections == 1
                             or self.cfg.projection_mode == "block")):
                    use_kernel = True
                with obs.span("server.stage"):
                    rs, w, seeds = _stage_weighted(
                        dev, ars, acoeffs, aseeds,
                        use_kernel is True and self.mesh is None)
                with obs.span("server.launch"):
                    params = self.proto.server_apply(
                        params, rs, seeds, w, mesh=self.mesh,
                        use_fused=use_kernel == "fused",
                        use_kernel=use_kernel is True,
                        fused_params=self.fused_params)
            else:
                uniform_exact = (self.cfg.sampler == "uniform"
                                 and a == cohort_size
                                 and st.applied_stale == 0
                                 and bool(np.all(acoeffs == acoeffs[0])))
                with obs.span("server.stage"):
                    if uniform_exact:
                        (frames,) = _dev_tensors(dev, ars)
                        w_b = None
                    else:
                        frames, w_b = _dev_tensors(dev, *_pad_bucket(ars, acoeffs))
                with obs.span("server.launch"):
                    params = self.proto.server_apply(params, frames, None, w_b)
            _sync(dev)
            apply_s = time.perf_counter() - t_apply
        return params, use_kernel, apply_s

    def close_digest(self, k: int, aseeds, acoeffs, ars, st, ids, params,
                     use_kernel: bool | str) -> int:
        """Digest-mode round close: broadcast the round's digest, mark the
        cohort synced, shadow-verify the replay → broadcast bits."""
        applied_round = bool(len(aseeds)) and not st.skipped
        dg = RoundDigest(
            round_idx=k,
            seeds=aseeds if applied_round else np.zeros(0, np.uint32),
            rs=(ars if applied_round
                else np.zeros((0, self.proto.payload_dim), np.float32)),
            coeffs=(acoeffs.astype(np.float32) if applied_round
                    else np.zeros(0, np.float32)))
        bits = self.downlink.broadcast(dg)
        self.client_last[ids] = k + 1   # the cohort heard the close broadcast
        if self.shadow is not None:
            self.shadow.apply_digest(dg, use_kernel=use_kernel)
            for x, y in zip(tree_leaves(params), tree_leaves(self.shadow.params)):
                if not torch.equal(x, y):
                    raise AssertionError(
                        f"digest replay diverged from the server at round {k}")
        return bits

    def evaluate(self, params) -> tuple[float, float]:
        loss = self.loss_fn(params, (self.xt, self.yt))
        acc = self.acc_fn(params, self.xt, self.yt)
        return float(loss), float(acc)

    @staticmethod
    def new_history(K: int) -> dict:
        hist = {k: np.zeros(K) for k in (
            "loss", "accuracy", "cum_bits", "cum_downlink_bits", "cum_wall_s",
            "cum_energy_j", "cum_downlink_wall_s", "cum_downlink_energy_j",
            "catchup_bits", "dense_resyncs", "cohort_size", "applied",
            "applied_stale", "lost_channel", "dropped_deadline",
            "dropped_stale", "weight_sum", "apply_s")}
        hist["loss"][:] = np.nan
        hist["accuracy"][:] = np.nan
        return hist

    def record_round(self, hist: dict, k: int, c: int, st, bits: float,
                     downlink_bits: float, wall: float, energy: float) -> None:
        """Write round ``k``'s counters and per-round costs into ``hist``;
        the downlink's wall and energy are priced from ``downlink_bits``."""
        hist["cohort_size"][k] = c
        hist["applied"][k] = st.applied
        hist["applied_stale"][k] = st.applied_stale
        hist["lost_channel"][k] = st.lost_channel
        hist["dropped_deadline"][k] = st.dropped_deadline
        hist["dropped_stale"][k] = st.dropped_stale
        hist["weight_sum"][k] = st.weight_sum
        hist["cum_bits"][k] = bits
        hist["cum_downlink_bits"][k] = downlink_bits
        hist["cum_wall_s"][k] = wall
        hist["cum_energy_j"][k] = energy
        _, dl_wall, dl_energy = self.downlink.round_cost(downlink_bits)
        hist["cum_downlink_wall_s"][k] = dl_wall
        hist["cum_downlink_energy_j"][k] = dl_energy

    def finalize(self, params, hist: dict, t0: float,
                 extra: dict | None = None) -> dict:
        """Cumsum the history, reconcile the downlink ledger, assemble
        the result dict."""
        cfg = self.cfg
        K = cfg.rounds
        for key in ("cum_bits", "cum_downlink_bits", "cum_wall_s",
                    "cum_energy_j", "cum_downlink_wall_s",
                    "cum_downlink_energy_j"):
            hist[key] = np.cumsum(hist[key])
        if int(hist["cum_downlink_bits"][-1]) != self.downlink.total_bits:
            raise AssertionError(
                f"downlink accounting leak: channel counted "
                f"{self.downlink.total_bits} bits, history recorded "
                f"{int(hist['cum_downlink_bits'][-1])}")
        applied_rounds = hist["apply_s"] > 0
        recon_clients_per_s = (
            float(np.sum(hist["applied"][applied_rounds])
                  / np.sum(hist["apply_s"][applied_rounds]))
            if applied_rounds.any() else 0.0)
        out = dict(
            method=f"runtime_{cfg.sampler}",
            protocol=self.proto.name,
            round=np.arange(1, K + 1),
            final_params=params,
            bits_per_client_per_round=self.codec.bits_per_upload,
            sim_compute_seconds=time.perf_counter() - t0,
            fused_path=False,
            pending_rounds=self.agg.pending_rounds(),
            sampling_diagnostic=sampling_diagnostic(self.sampler,
                                                    rounds=min(200, 4 * K)),
            sharding=self.shard_info,
            recon_clients_per_s=recon_clients_per_s,
            downlink_mode=cfg.downlink_mode,
            total_downlink_bits=self.downlink.total_bits,
            downlink_stats=dict(
                broadcast_bits=self.downlink.broadcast_bits,
                catchup_bits=self.downlink.catchup_bits,
                dense_resyncs=self.downlink.dense_resyncs),
            round_log=self.downlink.log,
            **hist,
        )
        if extra:
            out.update(extra)
        return out


def run_federation(
    cfg: RuntimeConfig,
    init_params: Any,
    client_sets,
    x_test: np.ndarray,
    y_test: np.ndarray,
    grad_fn: Callable | None = None,
    eval_fns: tuple[Callable, Callable] | None = None,
    client_weights: np.ndarray | None = None,
    device="cuda",
) -> dict:
    """Run K federation rounds on ``device`` → history dict of numpy arrays.

    ``client_sets`` are the data shards; client n reads shard n mod
    #shards.  ``grad_fn``/``eval_fns`` default to the paper's digits MLP.
    ``client_weights`` are the ``weighted`` sampler's relative weights
    (default: each virtual client's shard size).

    With ``cfg.scheduler`` set, the continuous-round scheduler drives the
    run (:mod:`repro_torch.fed.runtime.scheduler`): sync mode is
    bit-identical to the legacy loop, async mode pipelines rounds.
    """
    dev = resolve_device(device)
    if grad_fn is None:
        from repro_torch.models.mlp_classifier import mlp_grad
        grad_fn = mlp_grad
    if eval_fns is None:
        from repro_torch.models.mlp_classifier import mlp_accuracy, mlp_loss
        eval_fns = (mlp_loss, mlp_accuracy)

    num_shards = len(client_sets)
    proto = cfg.build_protocol(init_params)
    d = tree_size(init_params)
    if proto.name != "fedscalar" and cfg.mesh_shape is not None:
        raise ValueError(
            f"protocol {proto.name!r} cannot use mesh_shape: dense frames "
            "need a d-sized gather per upload on a sharded server; only "
            "fedscalar decodes shard-locally")
    if cfg.downlink_mode not in ("dense", "digest"):
        raise ValueError(f"unknown downlink_mode {cfg.downlink_mode!r}; "
                         "want 'dense' or 'digest'")
    if cfg.downlink_mode == "digest" and "digest" not in proto.downlink_modes:
        raise ValueError(
            f"protocol {proto.name!r} cannot use the digest downlink: its "
            "frames carry the d values themselves, so the server must ship "
            "the dense model every round")
    if cfg.verify_replay and cfg.downlink_mode != "digest":
        raise ValueError("verify_replay checks the digest-replay invariant; "
                         "set downlink_mode='digest'")
    if cfg.scheduler is not None:
        cfg.scheduler.validate(cfg)

    params = tree_map(lambda p: p.to(dev), init_params)
    method = None if cfg.scheduler is not None else _fused_method(cfg, num_shards)
    if method is not None:
        return _run_fused(cfg, params, client_sets, x_test, y_test, method,
                          proto, d, dev)
    core = EngineCore(cfg, params, client_sets, x_test, y_test, grad_fn,
                      eval_fns, client_weights, proto, d, dev)
    if cfg.scheduler is not None:
        from repro_torch.fed.runtime.scheduler import run_scheduled
        return run_scheduled(core, params)
    return _run_legacy(core, params)


def _run_legacy(core: EngineCore, init_params) -> dict:
    """One synchronous cohort per round, statement for statement the
    reference's loop (same RNG order, same apply choices).

    This is the scheduler's sync loop at quorum 1 without its summary:
    at that quorum the effective close is the config deadline and the
    weights are the cohort's own, so the two are one operation sequence.
    """
    from repro_torch.fed.runtime.scheduler import SchedulerConfig, _run_sync
    return _run_sync(core, init_params, SchedulerConfig(), summary=False)


def _run_fused(cfg: RuntimeConfig, init_params, client_sets, x_test, y_test,
               method: str, proto, d: int, device) -> dict:
    """Full-participation sync path → :func:`run_simulation`.

    Only the cost accounting is redone, with the runtime's per-upload
    channel draws.  Digest downlink: the simulation captures each round's
    (r, ξ), the rounds become uniform-mean digests, and with
    ``verify_replay`` a client replays them through the fused close (the
    simulation's own close) and must land on its bits.
    """
    from repro_torch.fed.costmodel import dense_downlink_bits, replay_round_costs
    from repro_torch.fed.simulation import SimulationConfig, run_simulation

    bits_per_upload = proto.wire_codec.bits_per_upload
    digest_mode = cfg.downlink_mode == "digest"
    sim = SimulationConfig(
        method=method, rounds=cfg.rounds, num_clients=cfg.population,
        local_steps=cfg.local_steps, batch_size=cfg.batch_size,
        local_lr=cfg.local_lr, seed=cfg.seed, channel=cfg.channel,
        capture_uploads=digest_mode)
    h = run_simulation(sim, init_params, client_sets, x_test, y_test,
                       device=device)

    K, n = cfg.rounds, cfg.population
    bits, wall, energy = replay_round_costs(
        cfg.channel, bits_per_upload, K, n,
        fedavg_bits_per_client=d * cfg.channel.float_bits, rng_seed=cfg.seed)

    cm = CostModel(cfg.channel, fedavg_bits_per_client=d * cfg.channel.float_bits,
                   rng_seed=cfg.seed)   # downlink_cost draws no RNG
    round_log = None
    if digest_mode:
        round_log = RoundLog(proto.digest_codec(),
                             window=max(cfg.downlink_log_window, K))
        dl_bits = np.zeros(K)
        for k in range(K):
            dg = RoundDigest(round_idx=k, seeds=h["seed_history"][k],
                             rs=h["r_history"][k], coeffs=None)
            dl_bits[k] = round_log.append(dg)
        if cfg.verify_replay:
            client = StatefulClient(init_params, proto)
            client.catch_up(round_log, use_kernel="fused")
            for x, y in zip(tree_leaves(h["final_params"]),
                            tree_leaves(client.params)):
                if not torch.equal(x, y):
                    raise AssertionError("fused-path digest replay diverged "
                                         "from run_simulation")
    else:
        dl_bits = np.full(K, float(dense_downlink_bits(d, cfg.channel.float_bits)))
    dl_costs = np.asarray([cm.downlink_cost(b) for b in dl_bits])
    total_dl = int(dl_bits.sum())

    h.update(
        method=f"runtime_{cfg.sampler}_fused",
        protocol=cfg.protocol_name,
        cum_bits=np.cumsum(bits),
        cum_downlink_bits=np.cumsum(dl_bits),
        cum_wall_s=np.cumsum(wall),
        cum_energy_j=np.cumsum(energy),
        cum_downlink_wall_s=np.cumsum(dl_costs[:, 1]),
        cum_downlink_energy_j=np.cumsum(dl_costs[:, 2]),
        catchup_bits=np.zeros(K),
        dense_resyncs=np.zeros(K),
        cohort_size=np.full(K, float(n)),
        applied=np.full(K, float(n)),
        applied_stale=np.zeros(K),
        lost_channel=np.zeros(K),
        dropped_deadline=np.zeros(K),
        dropped_stale=np.zeros(K),
        weight_sum=np.ones(K),
        apply_s=np.zeros(K),
        bits_per_client_per_round=bits_per_upload,
        fused_path=True,
        pending_rounds=[],
        sharding=None,
        recon_clients_per_s=0.0,
        downlink_mode=cfg.downlink_mode,
        total_downlink_bits=total_dl,
        downlink_stats=dict(broadcast_bits=total_dl, catchup_bits=0,
                            dense_resyncs=0),
        round_log=round_log,
        sampling_diagnostic=dict(empirical_marginal_abs_err=0.0,
                                 estimate_rel_err=0.0),
    )
    return h

"""Uplink protocols: one engine, three wire disciplines (port of ``repro/fed/protocols.py``).

An :class:`UplinkProtocol` says what a client puts on the wire and how
the server folds the round's surviving frames into the model:

* ``fedscalar`` — k projection scalars + a 32-bit seed (the paper);
* ``fedavg``    — the dense update δ, Θ(d) values;
* ``qsgd``      — d signed level codes + one norm per leaf.

``encode_cohort`` takes the deltas of a whole cohort (leaves with a
leading client axis) and returns float32 ``(C, payload_dim)`` payloads:
fedscalar encodes through the projection kernel, qsgd through the QSGD
kernel (one call per leaf for the cohort).  ``server_apply`` takes the
``(A, payload_dim)`` survivors plus optional ``(A,)`` weights; ``weights
=None`` is the paper's uniform mean, which for the dense protocols is
the same computation as :func:`repro_torch.core.fedavg.fedavg_round` /
:func:`repro_torch.core.qsgd.qsgd_round`.  Seeds are int64 tensors
holding 32-bit words.
"""
from __future__ import annotations

import abc
from typing import Any, Callable

import torch

from repro_torch.core import fedavg as fa
from repro_torch.core import fedscalar as fs
from repro_torch.core import qsgd as q
from repro_torch.core.prng import u32
from repro_torch.core.projection import leaf_layout, tree_size
from repro_torch.core.tree import tree_leaves, tree_unflatten
from repro_torch.kernels.qsgd_quant import qsgd_tree
from repro_torch.fed.costmodel import dense_downlink_bits
from repro_torch.fed.costmodel import queue_entry_bytes as _resident_entry_bytes
from repro_torch.fed.runtime.transport import (
    DenseFrameCodec,
    DigestCodec,
    QuantizedFrameCodec,
    WireFormat,
)

__all__ = [
    "UplinkProtocol",
    "FedScalarProtocol",
    "FedAvgProtocol",
    "QSGDProtocol",
    "PROTOCOLS",
    "make_protocol",
]

class UplinkProtocol(abc.ABC):
    """What one federated method contributes to the shared engine."""

    name: str
    wire_codec: Any
    #: downlink disciplines this protocol can serve; only fedscalar's
    #: update can be replayed from a digest of scalars.
    downlink_modes: tuple = ("dense",)

    @property
    def payload_dim(self) -> int:
        return self.wire_codec.payload_dim

    @property
    def upload_bits(self) -> int:
        """Uplink bits per client per round (costmodel single source)."""
        return self.wire_codec.bits_per_upload

    @property
    def queue_entry_bytes(self) -> int:
        """Resident bytes of one decoded upload in a server queue."""
        return _resident_entry_bytes(self.payload_dim)

    def downlink_bits(self, model_dim: int, float_bits: int = 32) -> int:
        """Per-round downlink payload under the dense discipline — Θ(d)."""
        return dense_downlink_bits(model_dim, float_bits)

    def digest_codec(self) -> DigestCodec:
        """→ the round-digest codec (digest-capable protocols only)."""
        raise ValueError(
            f"protocol {self.name!r} has no digest downlink: its frames "
            "carry the information itself, so the server must ship all d "
            "values every round")

    @abc.abstractmethod
    def client_payload(self, delta: Any, seed) -> torch.Tensor:
        """One client's update tree → float32 ``(payload_dim,)``."""

    @abc.abstractmethod
    def encode_cohort(self, deltas: Any, seeds: torch.Tensor, round_idx,
                      client_ids: torch.Tensor) -> torch.Tensor:
        """Deltas with a leading C axis → float32 ``(C, payload_dim)``.

        The batched form of :meth:`client_payload`; ``seeds`` are the
        engine's projection seeds, and protocols with their own streams
        (qsgd) key them by ``(round_idx, client_ids)``.
        """

    @abc.abstractmethod
    def server_apply(self, params: Any, payloads: torch.Tensor,
                     seeds: torch.Tensor | None,
                     weights: torch.Tensor | None) -> Any:
        """Fold the round's surviving frames into the model."""


class FedScalarProtocol(UplinkProtocol):
    """The paper's protocol: k scalars + a 32-bit seed, O(1) uplink."""

    name = "fedscalar"
    downlink_modes = ("dense", "digest")

    def __init__(self, params_like: Any, config: fs.FedScalarConfig,
                 wire: WireFormat | None = None):
        del params_like
        self.config = config
        self.wire_codec = wire if wire is not None else WireFormat(
            num_projections=config.num_projections)

    def digest_codec(self) -> DigestCodec:
        """Digest frames carry the same k scalars the uplink frames do."""
        return DigestCodec(num_blocks=self.wire_codec.num_projections)

    @classmethod
    def build(cls, params_like, *, fedscalar_config=None, wire_format=None,
              **_ignored):
        cfg = fedscalar_config if fedscalar_config is not None else fs.FedScalarConfig()
        return cls(params_like, cfg, wire_format)

    def client_payload(self, delta, seed):
        r, _ = fs.client_stage(delta, seed, self.config)
        return r

    def encode_cohort(self, deltas, seeds, round_idx, client_ids):
        """Every client's scalars from one kernel-path encode per leaf."""
        del round_idx, client_ids
        rs, _ = fs.encode_cohort(deltas, seeds, self.config)
        return rs

    def server_apply(self, params, payloads, seeds, weights, *,
                     use_kernel: bool = False, mesh=None,
                     use_fused: bool = False,
                     fused_params: dict | None = None):
        """fori (plain per-client loop), ``use_kernel`` (per-client decode
        kernel), ``use_fused`` (fused close kernel, with the tuned knobs of
        ``fused_params``: ``kernels.tune``'s winner, bits-invariant) or, on
        a ``mesh``, the sharded decode
        (:func:`repro_torch.core.fedscalar.server_aggregate_mesh`)."""
        cfg = self.config
        if mesh is not None:
            return fs.server_aggregate_mesh(params, payloads, seeds, cfg, mesh,
                                            weights=weights)
        if use_fused:
            from repro_torch.kernels import ops
            fp = fused_params or {}
            return ops.server_update_fused(
                params, payloads, seeds, server_lr=cfg.server_lr,
                distribution=cfg.distribution, weights=weights, mode=cfg.mode,
                block=fp.get("block"), row_slab=fp.get("row_slab"))
        if use_kernel:
            from repro_torch.kernels import ops
            return ops.server_update_kernel(
                params, payloads, seeds, server_lr=cfg.server_lr,
                distribution=cfg.distribution, weights=weights, mode=cfg.mode)
        return fs.server_aggregate(params, payloads, seeds, cfg, weights=weights)


class _DenseApplyMixin:
    """Unflatten (A, d) frames to per-leaf stacks and apply the mean."""

    def _layout(self, params_like):
        self.layout = leaf_layout(params_like)
        self.d = tree_size(params_like)

    def _leaf_stacks(self, flat: torch.Tensor):
        """(A, d) float32 → list of (A, *leaf_shape) float32 views."""
        return [flat[:, ll.offset:ll.end].reshape((flat.shape[0],) + ll.shape)
                for ll in self.layout]

    def _apply_mean(self, params, leaf_stacks, weights, server_lr):
        out = []
        for p, stack in zip(tree_leaves(params), leaf_stacks):
            if weights is None:
                g = torch.mean(stack, dim=0)
            else:
                w = weights.to(torch.float32).reshape(
                    (-1,) + (1,) * (stack.dim() - 1))
                g = torch.sum(stack * w, dim=0)
            out.append((p + server_lr * g).to(p.dtype))
        return tree_unflatten(params, out)


class FedAvgProtocol(_DenseApplyMixin, UplinkProtocol):
    """FedAvg: the full δ on the wire, Θ(d) bits."""

    name = "fedavg"

    def __init__(self, params_like: Any, config: fa.FedAvgConfig,
                 scalar: str = "fp32"):
        self.config = config
        self._layout(params_like)
        self.wire_codec = DenseFrameCodec(self.d, scalar=scalar)

    @classmethod
    def build(cls, params_like, *, fedavg_config=None, scalar_format="fp32",
              **_ignored):
        cfg = fedavg_config if fedavg_config is not None else fa.FedAvgConfig()
        return cls(params_like, cfg, scalar=scalar_format)

    def client_payload(self, delta, seed):
        del seed                       # dense frames are seedless
        return torch.cat([l.to(torch.float32).reshape(-1)
                          for l in tree_leaves(delta)])

    def encode_cohort(self, deltas, seeds, round_idx, client_ids):
        del seeds, round_idx, client_ids
        leaves = tree_leaves(deltas)
        n = leaves[0].shape[0]
        return torch.cat([l.to(torch.float32).reshape(n, -1) for l in leaves],
                         dim=1)

    def server_apply(self, params, payloads, seeds, weights):
        del seeds
        stacks = self._leaf_stacks(payloads.to(torch.float32))
        return self._apply_mean(params, stacks, weights, self.config.server_lr)


class QSGDProtocol(_DenseApplyMixin, UplinkProtocol):
    """QSGD: signed level codes + per-leaf norms.

    Encode runs the QSGD kernel's stochastic rounding keyed by (round,
    client id); decode multiplies the levels back by norm/levels, the
    client's own round-trip value, so the uniform-mean apply is
    :func:`repro_torch.core.qsgd.qsgd_round` on the same cohort.
    """

    name = "qsgd"

    def __init__(self, params_like: Any, config: q.QSGDConfig):
        self.config = config
        self._layout(params_like)
        self.num_leaves = len(self.layout)
        self.wire_codec = QuantizedFrameCodec(
            self.d, num_norms=self.num_leaves, bits=config.bits,
            norm_bits=config.norm_bits)

    @classmethod
    def build(cls, params_like, *, qsgd_config=None, **_ignored):
        cfg = qsgd_config if qsgd_config is not None else q.QSGDConfig()
        return cls(params_like, cfg)

    def client_payload(self, delta, quant_seed):
        leaves = tree_leaves(delta)
        return self._payload(q.tree_inputs(leaves, batched=False),
                             u32(quant_seed, leaves[0].device).reshape(1))[0]

    def encode_cohort(self, deltas, seeds, round_idx, client_ids):
        """Level codes and norms of the whole cohort: one ``qsgd_tree`` call,
        the (round, id)-keyed seeds derived in the kernel."""
        del seeds                      # rounding streams are (round, id)-keyed
        return self._payload(q.tree_inputs(tree_leaves(deltas)),
                             q.round_quant_seeds(round_idx, client_ids))

    def _payload(self, leaves, qseeds):
        return qsgd_tree(leaves, qseeds, self.config.levels, want_q=False,
                         want_levels=True)[1]

    def server_apply(self, params, payloads, seeds, weights):
        del seeds
        flat = payloads.to(torch.float32)
        norms = flat[:, self.d:]                       # (A, num_leaves)
        stacks = []
        for tag, ll in enumerate(self.layout):
            lv = flat[:, ll.offset:ll.end].reshape((flat.shape[0],) + ll.shape)
            nb = norms[:, tag].reshape((-1,) + (1,) * len(ll.shape))
            # norm · signed_level / levels: the client's round-trip value
            stacks.append(q.dequantize_levels(lv, nb, self.config.levels))
        return self._apply_mean(params, stacks, weights, self.config.server_lr)


PROTOCOLS: dict[str, Callable] = {
    FedScalarProtocol.name: FedScalarProtocol,
    FedAvgProtocol.name: FedAvgProtocol,
    QSGDProtocol.name: QSGDProtocol,
}


def make_protocol(name: str, params_like: Any, **kwargs) -> UplinkProtocol:
    """Build a registered protocol by name; each build ignores what it does not use."""
    if name not in PROTOCOLS:
        raise ValueError(f"unknown protocol {name!r}; registered: {sorted(PROTOCOLS)}")
    return PROTOCOLS[name].build(params_like, **kwargs)

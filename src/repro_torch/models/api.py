"""Unified architecture API: one object per assigned arch.

Counterpart of ``repro/models/api.py``.  ``Arch`` wraps a ModelConfig
of any family: the decoder-only ones (dense, MoE, SSM, hybrid, and the
VLM with its stubbed vision embeddings; ``models/lm.py`` takes each
layer's kind from the config) and the enc-dec (``models/encdec.py``),
with uniform entry points:

* ``init(seed, device, mesh=None)``      → params (on a mesh: resident in
  its shards, ``sharding/resident.py``)
* ``loss(params, batch)``                 → scalar CE  (train shapes)
* ``prefill(params, batch, capacity)``    → (logits, caches)
* ``decode(params, token, caches, pos)``  → (logits, caches), caches
  updated in place; both also serve from parameters resident on a mesh
  (the reference's ``zero3`` and ``tp`` serve layouts: a ``ResidentTree``,
  or ``sharding/resident.py::place_rows``' ``RowTrees``), the batch split
  over the data rows and each row's caches on its device (:class:`MeshCaches`)
* ``init_caches(batch, capacity, device)``
* ``param_shapes()``                      → the params as ``meta`` tensors
* ``input_specs(shape_name)``             → ``meta`` stand-ins for every
  input of the entry point of one of the four input shapes

``batch`` holds ``tokens`` (and ``labels`` for the loss) and, for a
frontend, ``embeds``: the VLM's patch embeddings, prepended to the text,
or the enc-dec's audio frames, which the encoder consumes.  Entry points
run on the CUDA card unless the caller passes ``device="cpu"``, or
``device="meta"``: shapes and dtypes with no storage, the reference's
``jax.eval_shape`` and ``ShapeDtypeStruct`` (the dry run,
``launch/dryrun.py``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.device import generator_for, resolve_device
from repro_torch.models import encdec as ed
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.models.moe import BatchDispatch
from repro_torch.sharding.resident import ResidentTree

__all__ = ["Arch", "INPUT_SHAPES", "LONG_WINDOW", "MeshCaches"]

# The four assigned input shapes: name → (seq_len, global_batch, mode)
INPUT_SHAPES = {
    "train_4k": (4096, 256, "train"),
    "prefill_32k": (32768, 32, "prefill"),
    "decode_32k": (32768, 128, "decode"),
    "long_500k": (524288, 1, "decode"),
}

# Sliding window used by full-attention archs at 500k decode.
LONG_WINDOW = 8192


class MeshCaches(NamedTuple):
    """The caches of a serve on a mesh: each data group's own (a
    ``LayerCaches`` or ``DecCaches`` of its rows), on its device, in batch
    order; ``Arch.prefill`` returns them and ``Arch.decode`` takes them."""
    groups: tuple


def _mesh_groups(params):
    """→ ``(compute device, tree)`` per data row for parameters resident on
    a mesh (``ResidentTree``: the reference's ``zero3`` serve; ``RowTrees``:
    its ``tp`` serve), None for a plain tree."""
    groups = getattr(params, "group_trees", None)
    return None if groups is None else groups()


def _rows(x, g: int, d: int, dev):
    """Group ``g``'s rows of ``x``'s leading (batch) axis split in ``d``, on
    ``dev``."""
    b = x.shape[0]
    if b % d:
        raise ValueError(f"batch {b} does not split over {d} data groups")
    return x[g * (b // d):(g + 1) * (b // d)].to(dev)


class Arch:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.is_encdec = cfg.encoder_layers > 0
        # the top-level keys of the param tree that stack periods or layers
        self.stacked_keys = ed.STACKED_KEYS if self.is_encdec else lm.STACKED_KEYS

    # ---------------- parameters ----------------
    def init(self, seed: int = 0, device="cuda", mesh=None):
        """Random parameters drawn from a ``torch.Generator`` seeded with
        ``seed``; on ``"meta"`` shapes and dtypes only, nothing allocated.

        With ``mesh`` (``launch/mesh.py``) → a
        :class:`~repro_torch.sharding.resident.ResidentTree` on it: the
        same draws on ``device``, bit for bit, each leaf (a stacked leaf
        one period at a time) placed in its shards before the next is
        drawn, so a model larger than one card can be initialised on a
        mesh of cards."""
        dev = resolve_device(device)
        gen = generator_for(dev, seed)
        into = None if mesh is None else ResidentTree.empty(self.param_shapes(), mesh)
        if self.is_encdec:
            return ed.init_encdec(self.cfg, gen, dev, into)
        return lm.init_lm(self.cfg, gen, dev, into)

    def param_shapes(self):
        """The parameter tree as ``meta`` tensors (the reference's
        ``jax.eval_shape`` of ``init``)."""
        return self.init(0, device="meta")

    # ---------------- training ----------------
    def loss(self, params, batch, window: Optional[int] = None,
             clients: bool = False, moe_dispatch=None):
        """Scalar CE; with ``clients`` every param and batch leaf leads with a
        client axis (N stacked replicas) → each client's CE, (N,).
        ``moe_dispatch``: ``lm.lm_forward``'s (the enc-dec has no MoE)."""
        if self.is_encdec:
            return ed.encdec_loss(params, self.cfg, batch, window=window,
                                  clients=clients)
        return lm.lm_loss(params, self.cfg, batch, window=window, clients=clients,
                          moe_dispatch=moe_dispatch)

    # ---------------- serving ----------------
    def prefill(self, params, batch, capacity: int, window: Optional[int] = None):
        """→ (last-token logits, caches).  ``params`` resident on a mesh (a
        ``ResidentTree``, or the ``tp`` layout's ``RowTrees``): the batch is
        split over the mesh's data rows, each row's prefill runs on its
        device with its caches there (→ :class:`MeshCaches`), each MoE layer
        dispatching the row as the whole batch's (``moe.BatchDispatch``);
        the logits come back in batch order on the first row's device."""
        groups = _mesh_groups(params)
        if groups is None:
            return self._prefill(params, batch, capacity, window)
        d = len(groups)
        moe = BatchDispatch(d) if self.cfg.num_experts and d > 1 else None
        logits, caches = [], []
        for g, (dev, tree) in enumerate(groups):
            part = {k: _rows(v, g, d, dev) for k, v in batch.items()}
            out, c = self._prefill(tree, part, capacity, window,
                                   None if moe is None else (moe, g))
            logits.append(out.to(groups[0][0]))
            caches.append(c)
        return torch.cat(logits), MeshCaches(tuple(caches))

    def _prefill(self, params, batch, capacity, window, moe_dispatch=None):
        if self.is_encdec:
            return ed.encdec_prefill(params, self.cfg, batch["embeds"],
                                     batch["tokens"], capacity=capacity,
                                     window=window)
        return lm.lm_prefill(params, self.cfg, tokens=batch.get("tokens"),
                             embeds=batch.get("embeds"), capacity=capacity,
                             window=window, moe_dispatch=moe_dispatch)

    def decode(self, params, token, caches, position, window: Optional[int] = None):
        """→ (logits, caches), the caches updated in place; on a mesh (as
        :meth:`prefill`) each data row decodes its rows of ``token``
        against its own caches of the :class:`MeshCaches` given."""
        groups = _mesh_groups(params)
        if groups is None:
            return self._decode(params, token, caches, position, window)
        if not isinstance(caches, MeshCaches) or len(caches.groups) != len(groups):
            raise TypeError(f"a serve on {len(groups)} data rows takes the "
                            "MeshCaches of its prefill")
        d = len(groups)
        logits = [self._decode(tree, _rows(token, g, d, dev), caches.groups[g],
                               position, window)[0].to(groups[0][0])
                  for g, (dev, tree) in enumerate(groups)]
        return torch.cat(logits), caches

    def _decode(self, params, token, caches, position, window):
        if self.is_encdec:
            return ed.encdec_decode(params, self.cfg, token, caches, position,
                                    window=window)
        return lm.lm_decode(params, self.cfg, token, caches, position,
                            window=window)

    def init_caches(self, batch: int, capacity: int, device="cuda"):
        """Empty caches; the enc-dec's hold zero encoder states of shape
        (batch, encoder_seq, d_model), as in the reference."""
        dev = resolve_device(device)
        if self.is_encdec:
            enc = torch.zeros((batch, self.cfg.encoder_seq, self.cfg.d_model),
                              dtype=self.cfg.torch_dtype, device=dev)
            return ed.init_decoder_caches(self.cfg, batch, capacity, enc)
        return lm.init_lm_caches(self.cfg, batch, capacity, device=dev)

    # ---------------- shape plumbing ----------------
    def decode_window(self, seq_len: int) -> int:
        """Cache capacity for a decode shape — full attention archs cap the
        ring at LONG_WINDOW beyond 32k (sliding-window carve-out)."""
        if seq_len > 32768:
            return LONG_WINDOW
        return seq_len

    def supports(self, shape_name: str) -> bool:
        return shape_name in INPUT_SHAPES

    def input_specs(self, shape_name: str, global_batch: Optional[int] = None) -> dict:
        """``meta`` stand-ins for every model input of this shape, under the
        reference's keys (int32 tokens and scalars, as its
        ``ShapeDtypeStruct`` stand-ins); ``global_batch`` cuts the shape's
        batch (the dry run's checks on one card):

          train:   {"batch": {tokens, labels[, embeds]}, "round_idx"}
          prefill: {"batch": {tokens[, embeds]}}
          decode:  {"token", "caches", "position"}
        """
        cfg = self.cfg
        seq, gbatch, mode = INPUT_SHAPES[shape_name]
        if global_batch is not None:
            gbatch = global_batch
        meta = torch.device("meta")

        def sd(shape, dtype):
            return torch.empty(shape, dtype=dtype, device=meta)

        def frontend_embeds(b):
            if cfg.frontend == "vision":
                return sd((b, cfg.num_frontend_tokens, cfg.d_model), cfg.torch_dtype)
            if cfg.frontend == "audio":
                return sd((b, cfg.encoder_seq, cfg.d_model), cfg.torch_dtype)
            return None

        i32 = torch.int32
        if mode in ("train", "prefill"):
            text = seq
            if cfg.frontend == "vision":
                text = seq - cfg.num_frontend_tokens
            batch = {"tokens": sd((gbatch, text), i32)}
            if mode == "train":
                batch["labels"] = sd((gbatch, text), i32)
            fe = frontend_embeds(gbatch)
            if fe is not None:
                batch["embeds"] = fe
            if mode == "train":
                return {"batch": batch, "round_idx": sd((), i32)}
            return {"batch": batch}

        # decode: one new token against a filled cache
        capacity = self.decode_window(seq)
        return {
            "token": sd((gbatch, 1), i32),
            "caches": self.init_caches(gbatch, capacity, device=meta),
            "position": sd((), i32),
        }

    def serve_window(self, shape_name: str) -> Optional[int]:
        """Window override passed to decode for this shape."""
        seq, _, mode = INPUT_SHAPES[shape_name]
        if mode == "decode" and seq > 32768 and self.cfg.num_heads:
            return LONG_WINDOW
        return None

#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card and check its kernels.

Run from the repository root, with no arguments::

    python3 chip_smoke.py

Phases (any failure exits non-zero and the final line is not printed):

1. device: the card's name, count, and ``nvidia-smi`` name and power limit;
2. build: the eight CUDA sources with nvcc (in parallel), with ptxas's
   registers and spills per kernel;
3. kernels against their plain PyTorch versions, on the card, at the MLP
   leaves, a SmolLM-360M-sized tied embedding (49152, 960) for k = 1 and
   FULL k = 8, and a (960, 2560) leaf for BLOCK k = 8; all four direction
   families, nonzero row/col offsets, cohorts 20, 33 and 1000.  The fused
   close and the per-client decode must equal their plain versions
   bitwise for the ±1/±2 families (gaussian within rtol/atol 1e-5); the
   encode within ``encode_tolerance`` (4·2⁻²³·√h·‖x‖₂·max|v|, h the depth
   of its float32 sum) of its plain version summed in float64, and
   bitwise equal to itself across runs; the QSGD kernel bitwise equal to
   its plain version given the same norms (bits 2, 4, 8; a leaf of zeros),
   one leaf at a time and through the tree entry ``qsgd_tree`` with the
   norms from its own norm pass (the MLP tree at N = 1000 and 256, a zero
   tree, the large leaf at N = 16): q and the payload bitwise against
   ``qsgd_tree_plain`` given the kernel's norms, those norms within
   ``norm_tolerance`` (h·2⁻²⁴·‖x‖₂, h the depth of its float32 sum) of
   the float64 norm and the same bits on a rerun;
4. main path of the first slice: ``run_simulation`` on the card for
   fedscalar_rademacher, fedscalar_gaussian, fedscalar_block8,
   fedscalar_ef and qsgd (N = 20, S = 5, B = 32); the encode and
   fused-close counters (qsgd: the QSGD counter) must move, no other, and
   the loss must fall; one fedscalar round on the card must match the same
   round on the CPU (atol 1e-6);
5. main path of the runtime slice: ``run_federation`` on the card at the
   population of ``examples/runtime_scale.py`` (100 000 clients, 1 %
   participation: cohorts of 1000), 10 rounds each for fedscalar through
   the per-client decode, fedscalar through the fused close, fedscalar
   with the digest downlink and a shadow replay, fedavg and qsgd; the
   expected counters must move, the loss must fall, the replay must stay
   bit-identical, qsgd must take two QSGD launches a cohort chunk (the
   norm pass and the quantize launch), and one round on the card must
   match the same round on the CPU (atol 1e-6; qsgd 2e-6, for a level
   flipped by the norm's last bit);
   then the continuous-round scheduler at ``benchmarks/run.py``'s
   scheduler shape (100 000 clients, cohorts of 1000, 20 rounds, seed 0,
   the digest downlink, 20 ms base latency, lognormal σ 0.5): the legacy
   loop, the sync scheduler (its params bitwise the legacy run's on the
   card) and the async scheduler (a round opened every 1 ms, 32 in
   flight, staleness window 4), whose modeled makespan, clients/s, model
   lag and state bytes must equal ``experiments/scheduler/throughput.csv``
   to its printed digits; async on the fused close (one fused launch a
   round) and async qsgd on the dense downlink (two QSGD launches a
   cohort chunk); every scheduler run launches the encode each round and
   the decode-route runs the per-client close each round (1000 ≥ 512
   uploads); 3 rounds of async fedscalar and async qsgd on the card
   against the CPU (the decode threshold pinned at 512 on both): every
   stats array and the schedule bitwise, params within 1e-6 (qsgd
   2e-6); and the state audit at 10⁶ clients (async, digest, 2 rounds:
   4 000 000 bytes of per-client state);
6. times from CUDA events: each kernel, its plain version and its bound,
   at the main paths' shapes and at the large leaf (cohorts 256, 1024 for
   both decodes; 16 clients for the encode and QSGD); the runtime's
   decode of a round through ``ops.server_update_kernel`` (one tree
   launch) and its qsgd encode through ``QSGDProtocol.encode_cohort``
   (four chunks, two launches each), each with its device and enqueue
   times apart; the large leaf through ``qsgd_tree`` (norms in the
   kernel) beside the kernel given the norms;
7. flash attention against its plain version, on the card, through
   ``flash_attention`` (which routes bf16 to the tensor-core prefill or
   the split-KV decode, float32 to the float32 kernel or the split-KV
   decode): bf16 and f32, head_dim 32, 64 and 128, MHA, GQA with group 3
   and MQA, causal and a window of 64, ``kpos = -1`` holes and padding
   queries, ragged S = T of 333 and 1000, decode (S = 1) against T =
   16 424, a wrapped ring (unsorted kpos), and SmolLM-360M's prefill
   shape in both types; on rows with an allowed key, f32 within
   ``tests/test_flash_kernel.py``'s rtol 1e-3 / atol 2e-5, bf16 within
   2^-7 of its row's largest |plain| (at most one bf16 ulp) and with at
   most 1% of its elements changed (``kernels.flash_attention.flash_agrees``);
8. the three flash kernels' times (CUDA events) in turns (kernel,
   ``scaled_dot_product_attention``, kernel): the prefill kernel at
   SmolLM-360M's prefill shape, the decode kernel at its decode shape,
   the float32 kernel at the parity prefill (phase 9), each beside its
   bound and its plain version (SDPA is timed only, as a yardstick);
9. main path of the serving slice, card against CPU: SmolLM-360M at full
   width, depth cut to 2 layers, float32, batch 1, a prompt of 8448
   tokens and 4 decode steps against a cache of 8460 slots (both over
   the 8192 threshold, so both phases launch a kernel: the float32
   kernel at prefill, the split-KV decode at each step); logits and
   the KV caches within ``PARITY_ATOL`` of the CPU run; then the same in bf16 on
   the card with the kernels (the tensor-core prefill, the split-KV
   decode) against the same run with ``_sdpa_blocked`` taking the plain
   version, logits within ``BF16_PARITY_RTOL`` of their largest;
10. main path of the serving slice at full width and depth: SmolLM-360M,
   32 layers, bf16, batch 4, a prompt of 16 384 tokens and 32 greedy
   decode steps against a cache of 16 424 slots through
   ``launch/serve.py``'s steps, timed, with the host's enqueue time
   beside each phase's; the flash counter must read 32 + 32 × 32, the
   prefill kernel's 32 and the decode kernel's 32 × 32;
11. the four FedScalar/QSGD kernels on bf16 leaves against their plain
   versions, at SmolLM-360M's 11 leaves (its real bf16 weights; the
   stacked leaves as 2-D views, such as (32, 2560, 960) as 81 920 rows):
   rademacher at every leaf (encode N = 1, decode and fused close N = 4,
   QSGD N = 1), all four families at the embedding and the stacked FFN
   leaf.  Close and decode bitwise for the ±1/±2 families (gaussian within
   rtol/atol 1e-5 plus one bf16 ulp, where the float32 values round
   apart); the encode within ``encode_tolerance``; QSGD bitwise; the 11
   leaves through the QSGD tree entry (N = 1, bits 8 and 4) as in phase 3;
12. main path of the training slice, card against CPU: SmolLM-360M at
   full width, 2 layers, float32, ``launch/train.py``'s ``train_step``
   for one round (N = 4 clients, S = 2 local steps, per-step batch 1 ×
   512 tokens): loss, every client's r and the new params within the
   limits stated at ``TRAIN_LOSS_ATOL``; the card's attention through
   the flash training kernels (two forward launches and one backward a
   layer, client and step);
13. main path of the training slice at full width and depth: SmolLM-360M,
   32 layers, bf16, random weights from seed 0, rademacher, k = 1, N = 4,
   S = 2, per-step batch 1 × 4096 tokens (``train_4k``'s sequence; its
   global batch of 256 cut to 8 sequences per round), local lr 0.05,
   server lr 1; a warm-up round, then 3 timed rounds: round s, local-SGD
   s, training tokens/s, encode and close ms (CUDA events) beside their
   bounds, launches, peak GiB, loss, r_rms and uploaded scalars; the
   warm-up round's close held bitwise against ``server_aggregate`` and its
   plain version on the card given that round's params, rs and seeds, and
   one close launch per round;
   the trained bf16 model
   saved and restored through ``repro_torch.checkpoint``, bit for bit.

14. the tree launches (after phase 3): ``ops.project_tree_kernel`` and
   ``ops.server_update_fused`` against their plain tree versions on the
   MLP tree (one launch each) and a 70-leaf tree (two launches: the leaf
   table holds 64), float32 and bf16, all four families, k = 1, FULL 8
   and BLOCK 8; the encode within ``tree_encode_tolerance`` and the same
   bits on a rerun, the close bitwise for the ±1/±2 families; the
   per-client decode's tree launch (``ops.server_update_kernel``) on the
   MLP tree (N = 20 and 1024) and the 70-leaf tree, plain and with
   per-client rounding, bitwise; then leaves past the old launch grids: 524 288 × 1 through the fused close and the
   per-client decode, 262 144 × 2 through QSGD, bitwise; the QSGD tree
   entry as in phase 3 on the MLP tree (N = 1000, two launches), the
   70-leaf tree (four) and the 262 144 × 2 leaf, float32 and bf16, bits 2,
   4, 8, and each leaf's norm the same as in a tree of its own; and in phase 11,
   SmolLM-360M's 11 bf16 leaves in one launch (encode N = 1, k = 1 and
   FULL 8; close N = 4) and its 2-layer leaves under 2²⁴ elements in
   BLOCK 8.  Phase 6 times the MLP round through the tree entry points
   (one launch for the close, two for the encode) with and without the
   host's enqueue, the runtime's decode (one launch) the same way, and
   phase 13 the train round's encode and close (one launch) likewise;
15. training above the blocked-attention threshold (after phase 12):
   SmolLM-360M at full width, 2 layers, float32, 8448 tokens under
   autograd: loss and gradients through ``_sdpa_blocked`` against the
   plain ``_sdpa`` with its flash route off, once as float32 runs (the
   flash training kernels, never the blocked recurrence) and once with the
   flash route off, as bf16 training and prefix prefills run (the plain
   blocked recurrence, twice a layer); phase 13's close
   (per-client rounding) is held bitwise against ``server_aggregate``.
16. the mesh-sharded server (after phase 5; ``sharding/fed_rules.py``):
   the decode, the fused close and the encode over shard plans (one tree
   launch per 64 (shard, leaf) entries) against their plain versions over
   the same plans on a (1, S) mesh of the card, S = 1, 3, 8: the MLP tree
   (N = 37; all families at k = 1, FULL 8 and BLOCK 8 at S = 3 and 8) and
   SmolLM-360M at full width, 2 layers (N = 4; float32 and bf16), the
   decode and close bitwise for the ±1/±2 families (gaussian within
   rtol/atol 1e-5) and bitwise the unsharded kernels for every family,
   the encode within ``tree_encode_tolerance`` of the shards' views and
   the same bits on a rerun; the resident loop (``shard_tree`` +
   ``sharded_apply_blocks``) at SmolLM-360M's 11 bf16 leaves, N = 256,
   k = 1, S = 1, 2, 4, 8, bitwise the unsharded decode and fused close,
   ⌈11·S/64⌉ launches an apply, device ms in turns with the unsharded
   decode beside the bound over the padded elements; the sharded encode
   at full width (S = 8) within the two encodes' tolerances of the
   unsharded tree encode; the
   reference's sharding sweep (d = 2¹⁸, 2²⁰ as (512, d/512), cohorts 64
   and 256, S = 1, 2, 4, 8; rows printed); ``run_federation`` at
   100 000 clients under ``mesh_shape=(2, 4)`` with the digest downlink
   and the shadow replay, 10 rounds, bitwise the same run on the decode
   route, one decode launch (48 entries) per mesh apply and no fused
   launch; 3 rounds each of sync and async scheduling under
   ``mesh_shape=(2, 4)``, bitwise their mesh-less runs.

17. the MoE, SSM and hybrid families (after phase 10; ``models/moe.py``,
   ``models/mamba.py``: plain PyTorch, as the reference's einsums and
   associative scan have no Pallas kernel; flash is their only kernel):
   reduced Qwen3-MoE (k = E = 4, and k = 2, which drops at the capacity),
   Falcon-Mamba and Jamba (8 layers), float32, phase 9's prompt of 8448
   tokens and 4 decode steps on the card against the CPU: the card's MoE
   routes recorded through ``moe._route`` and replayed on the CPU
   (``tests/torch_parity.py::MoERoutes``; where the CPU's own choice
   differs, and the largest logit margin there, printed; a difference
   beyond a near tie, 1e-4, fails), logits and every cache (KV, Mamba h
   and conv) within
   ``PARITY_ATOL``, the exact float32-kernel and split-KV launches; then
   bf16 at full width, batch 1, prompt 16 384, 32 greedy decode steps,
   cache 16 424, through the serve steps: Qwen3-MoE-30B-A3B (48 layers),
   Falcon-Mamba-7B (64 layers), Jamba-v0.1-52B over 2 of its 4 periods
   (16 layers): init s and parameter GiB, prefill s, decode ms a token,
   host enqueue, peak GiB, the prefill's MoE dropped fraction, the
   decode's all-experts read beside its bytes bound, the flash launches
   exactly one prefill and 32 decode launches per attention layer and no
   other kernel, KV positions, finite caches, tokens in the vocabulary;
   and the first attention layer's own q, k, v (G = 8 at hd 64; G = 4 at
   hd 128) of each prefill and of each first decode step (S·G = 8 and 4
   rows a kv head, 16 424 slots) through the prefill and split-KV decode
   kernels against their plain version.

18. the VLM and enc-dec families (after phase 13; PaliGemma-3B through
   ``models/lm.py`` with its stubbed patch embeddings, Whisper-tiny through
   ``models/encdec.py``; flash at head_dim 256): the three flash kernels at
   hd 256 (PaliGemma's 8 heads over 1) against their plain version — ragged
   S and T, kpos holes, padding queries, window 64, a wrapped ring, decode
   over 16 384 slots in bf16 and float32, the bf16 prefill at S = T =
   16 384, the float32 kernel at 8448 — and Whisper's decoder prefill (B 4,
   S = T = 8448, 6/6, hd 64), each timed beside its bound and SDPA (K/V
   repeated in float32); card against CPU, float32, phase 9's prompt and
   cache: reduced PaliGemma and its hd-256 variant (16 embeddings + 8432
   tokens; the prefix prefill on the plain recurrence, the split-KV decode
   past the prefix) and reduced Whisper (64 frames; the float32 kernel at
   prefill), logits and caches within ``PARITY_ATOL``; reduced Whisper's
   prefill and decode logits against its full decoder forward on the card
   (8448 tokens, 1e-4); PaliGemma-3B (18 layers, batch 1, 256 embeddings +
   8192 tokens) and Whisper-tiny (batch 4, 1500 frames + 8448 tokens: the
   decoder's positions wrap mod 4096) at full width, bf16, into 16 384
   slots, 32 greedy steps, timed: exactly 18 × 32 split-KV launches for
   PaliGemma (its prefill, inside the prefix, none), 4 prefill and 4 × 32
   decode launches for Whisper; flash on their own first-layer q, k, v;
   one FedScalar round of each at full width, bf16, through
   ``launch/train.py`` (rademacher, k = 1, N = 2, S = 1; 256 embeddings +
   1792 tokens, 1500 frames + 448 tokens a client): each r within
   ``tree_encode_tolerance`` of the plain encode of its own δ, the close
   bitwise ``server_aggregate`` and its plain version.

19. leaves past 2³¹ elements, the dry run against the card, the
   client-parallel step (after phase 18; ``launch/dryrun.py``,
   ``launch/roofline.py``, ``launch/train.py::
   make_train_step_client_parallel``): Falcon-Mamba-7B's in_proj, (64 ·
   4096, 16 384) bf16, 2³² elements: the encode (N = 1) within
   ``encode_tolerance`` of its plain float64 sum, the per-client decode
   (N = 4, per-client rounding) and the fused close (N = 4) bitwise their
   plain versions over row ranges of 4096 rows, each timed beside its
   bound; the dry run over all ten configs × four shapes (``--fit``, in 4
   low-priority processes started as the phase begins, waited for at its
   end):
   one row each of the one-card argument and peak GiB, fits the card or
   not, the H100 bound and its dominant term, and both reference meshes'
   per-device argument GiB; at the dry run's cuts, each step on the card
   with its ``max_memory_allocated`` within 15% of the full-depth meta
   estimate and its time beside the one-card bound: SmolLM-360M
   ``train_4k`` (N = 4, S = 2, batch 8), ``prefill_32k`` (batch 1),
   ``decode_32k`` (batch 16, every cache full), and one Minitron-8B round
   at full width and depth (N = 2, S = 1, batch 2; its two 2³¹-element
   leaves through the encode and close) when its estimate is under 90% of
   the card, its close bitwise its plain version leaf by leaf; the
   client-parallel step against the sequential one (SmolLM-360M, 32
   layers, bf16, N = 4, S = 2, 1 × 4096): one encode launch group against
   four, the loss within 1%, both rounds' time and peak beside its meta
   estimate; each client's r within ``tree_encode_tolerance`` of the plain
   encode of its own δ, each client-parallel δ nearest its own client's
   sequential δ, each r within 6‖Δδ‖₂ and both encodes' tolerances of the
   sequential step's; then float32 at 2 layers, the card against the CPU
   within phase 12's limits.  QSGD past 2³¹ (``qsgd_tree``, 8 bits, N =
   1): the 2³² leaf, and a two-leaf tree whose second leaf (8 × 8) starts
   at payload column 2³¹; q and the payload bitwise ``qsgd_quantize_plain``
   over row ranges given the kernel's norms, the norms within
   ``norm_tolerance``; the 2³² leaf's call timed beside its bound, and
   with the norms given (the quantize pass alone).

20. the fused close's autotuner (after phase 19; ``kernels/tune.py``, a
   temporary cache file): the sweep over ``tree.CLOSE_TILES`` at the MLP's
   dominant leaf (64 × 24, float32, N = 20: bucket 32) and SmolLM-360M's
   tied embedding (float32 N = 256 and 1024, bf16 N = 256), each tile's
   CUDA-event median of 3 beside its bound, and the winner against the
   default in turns (5 calls each); a second sweep with a measure
   that raises returns the stored winners, as does another process; every
   tile bitwise the default tile for all four families (the MLP tree at
   k = 1, FULL 8 and BLOCK 8, float32 and bf16; the (960, 2560) leaf in
   BLOCK 8; the tied embedding at N = 256, float32 and bf16) and against
   the plain version as the default is (bitwise for the ±1/±2 families,
   gaussian within rtol/atol 1e-5); phase 5's fused-close run at 10⁵
   clients with a non-default tile cached for its dominant leaf bitwise
   the run without.  The ``kernels`` line's fused-close entry carries each
   workload's winner and default tile with their ms in turns.

21. the train step on a device mesh (after phase 20;
   ``launch/train.py::make_train_step(..., mesh=)``,
   ``sharding/resident.py``): SmolLM-360M at full width and depth, bf16,
   rademacher, k = 1, N = 2, S = 1, a global batch of 4 × 4096 tokens,
   on (1, 4) and (2, 2) meshes of four entries on the one card against
   the unsharded round.  A check round each (deterministic algorithms on:
   the embedding's backward sums in a fixed order): on (1, 4) every
   client's δ bitwise the unsharded round's, its r within
   ``tree_encode_tolerance`` (over the shards' views) of the float64
   encode of that δ, and, given the unsharded round's r, the close
   bitwise the unsharded close.  Then a timed round each (unsharded,
   (1, 4), (2, 2)): round s, ``max_memory_allocated`` (and above the
   round's start), the weights gathered a step, resident bytes per mesh
   entry beside ``per_device_bytes(param_specs)``; the (1, 4) loss
   bitwise the unsharded loss, the (2, 2) round's r within 2⁻⁸·√S·‖x‖₂
   and its params within Σₙ(|Δrₙ| + 2⁻⁸(|rₙ| + |r'ₙ|))/N plus one bf16
   ulp of the unsharded round's; each round's encode (two counts per device's tree launch per
   client) and close (one per device) launches exact.  The bf16 bound on
   r is far above r itself, so a float32 round of the same shape on
   (2, 2) holds the data groups' gradient sum: its loss within 1e-4, each
   r within 1e-5·(1 + |r|) and its params within Σₙ|Δrₙ|/N + 1e-6 of the
   float32 unsharded round's (the card tests' float32 limits; a group's
   gradient lost or the groups' losses summed moves r by about |r|), its
   attention through the flash training kernels, launches exact.
22. serving from resident shards on a mesh (after phase 21;
   ``models/api.py``, ``sharding/resident.py::place_rows``): SmolLM-360M
   at full width and depth, bf16, batch 4, a 16 384-token prompt and 32
   greedy steps through the serve steps, on (1, 4) and (2, 2) meshes of
   four entries on the one card, in the reference's zero3 (one resident
   tree) and tp (a resident tree a data row) layouts, beside the unsharded
   serve of the whole batch and of each half: on (1, 4) the tokens, the
   last logits and every cache tensor bitwise the unsharded serve's, on
   (2, 2) each data group's bitwise the unsharded serve of its own two
   rows; the flash launches exact (one prefill launch per attention layer
   and group, one decode launch per attention layer, group and step) and
   no other kernel; prefill s, decode ms a step and peak GiB each.
23. the client-parallel step on a mesh (after phase 22;
   ``launch/train.py::make_train_step_client_parallel(..., mesh=)``):
   SmolLM-360M, bf16, N = 2, S = 2, 1 × 4096 tokens a step, on a (2, 2)
   mesh of four entries on the one card (a client a data row, its replica
   over the row's two entries) against the one-device client-parallel
   round at the same N, S, batch and seeds: round s and peak GiB beside the
   one-device round's and the meta estimate, the launches exact; then, with
   deterministic algorithms, each δ bitwise the one-device step run on its
   row's clients alone, each r within ``tree_encode_tolerance`` of the
   float64 encode of that δ, and the close given the one-device r bitwise
   the one-device close; a replica's resident bytes per entry beside
   ``per_device_bytes`` under ``param_specs(layout="tp")``.

24. the float32 flash training kernels (``csrc/flash_attention.cu`` with
   its lse output, ``csrc/flash_attention_bwd.cu``) at Minitron-8B's
   attention, (1, 4096, 48/8, 128) causal: the backward bitwise on a
   rerun and within 1e-4 of its plain version's largest |gradient|; each
   kernel's CUDA-event time in turns with its plain version, beside its
   bound (the FMAs the function needs an allowed pair, 2·hd forward and
   5·hd backward, at the float32 FMA rate); a FlashAttentionF32 forward and backward beside the plain
   ``_sdpa`` under autograd and ``scaled_dot_product_attention``'s (timed
   only, as a yardstick).

The line before the last is a JSON object ``{"kernels": [...]}``; the
last is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent

# NVIDIA H100 SXM: HBM3 rate from the data sheet.  Instruction rates are
# results per clock per SM from the CUDA C++ Programming Guide's
# arithmetic-instruction throughput table (compute capability 9.0: 128
# for float32 add or multiply, 64 for 32-bit integer add, logic, shift,
# compare and multiply), times 132 SMs at 1.98 GHz; the data sheet's
# 67 TFLOP/s float32 is the same 128 lanes with an FMA counted as two.
# Issue is 4 warp instructions per clock per SM, 128 lanes in all.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 132 * 128 * 1.98e9        # 33.5e12 non-FMA float32 ops/s
INT32_OPS_PER_S = 132 * 64 * 1.98e9        # 16.7e12 int32 ops/s, each class
ISSUE_PER_S = 132 * 128 * 1.98e9           # all instructions together

FAMILIES = ("rademacher", "gaussian", "sparse_rademacher", "hadamard")
EXACT = ("rademacher", "sparse_rademacher", "hadamard")
# Least ops per (element, client, block) of the rademacher chain after the
# hoisted rounds, by class (the times are timed with rademacher):
# integer add/logic/shift/select: the input xor, the round's add, three
# shifts, two xors, the last xor merged with the bit-8 test into one
# 3-input logic op, the ±1 select (9); integer multiplies (2); float32
# multiply and add (2).  Both kernels do the same per element.
ELEM_OPS = {"int": 9, "imul": 2, "fp": 2}
# Per (row, client, block): two SplitMix32 rounds and two xors.
ROW_OPS = {"int": 16, "imul": 4, "fp": 0}
MAIN_METHODS = ("fedscalar_rademacher", "fedscalar_gaussian", "fedscalar_block8",
                "fedscalar_ef", "qsgd")
# The kernels each method of phase 4 must launch (the fedscalar ones: the
# encode and the fused close; qsgd its round trip through the tree entry).
MAIN_KERNELS = {"qsgd": ("qsgd",)}
MAIN_ROUNDS = 40
LARGE = (49152, 960)             # SmolLM-360M tied embedding (vocab, d_model)
LARGE_BLOCK = (960, 2560)        # SmolLM-360M MLP width, under 2**24 elements
MLP = [(1, 24), (1, 12), (1, 10), (64, 24), (24, 12), (12, 10)]
# Runtime phase: examples/runtime_scale.py's population and participation.
RT_POPULATION, RT_PARTICIPATION, RT_ROUNDS, RT_SHARDS = 100_000, 0.01, 10, 20
RT_CONFIGS = {   # name -> (RuntimeConfig overrides, kernels that must run)
    "fedscalar_rec": (dict(), ("encode", "rec")),
    "fedscalar_fused": (dict(projection_mode="fused_kernel"), ("encode", "fused")),
    "fedscalar_digest_replay": (dict(downlink_mode="digest", verify_replay=True),
                                ("encode", "rec")),
    "fedavg": (dict(protocol_name="fedavg"), ()),
    "qsgd": (dict(protocol_name="qsgd"), ("qsgd",)),
}
# Scheduler runs: benchmarks/run.py's bench_scheduler_throughput shape,
# checked against the rows it wrote (read as data, not imported).
SCHED_CSV = "experiments/scheduler/throughput.csv"
SCHED_ROUNDS, SCHED_PARITY_ROUNDS = 20, 3
SCHED_ASYNC = dict(mode="async", period_s=0.001, max_rounds_in_flight=32,
                   staleness_window=4)
SCHED_RUNS = {   # name -> (RuntimeConfig overrides, scheduler, kernels that run,
                 #          the CSV row its modeled figures must equal)
    "legacy": (dict(), None, ("encode", "rec"), None),
    "sched_sync": (dict(), dict(mode="sync"), ("encode", "rec"), "sync"),
    "sched_async": (dict(), SCHED_ASYNC, ("encode", "rec"), "async_pipelined"),
    "sched_async_fused": (dict(projection_mode="fused_kernel"), SCHED_ASYNC,
                          ("encode", "fused"), None),
    "qsgd_sched_async": (dict(protocol_name="qsgd", downlink_mode="dense"),
                         SCHED_ASYNC, ("qsgd",), None),
}
# The schedule's arrays a card run must share bit for bit with a CPU run,
# beside the history's per-round counters and costs.
SCHEDULE_KEYS = ("starts", "closes", "drains", "params_lag")
# History arrays that hold host timings or evaluations, not round counters.
UNSHARED_HISTORY = ("loss", "accuracy", "apply_s")
# QSGD per element: the one unhoisted SplitMix32 round (xor, add, three
# shift-xor pairs: 8 integer ops, 2 multiplies) and the float ops of the
# spec (convert, +1, ·2⁻³², |x|/norm, ·L, floor, −, <, +, sign·level,
# norm·sign, ·level, /L: 13, each IEEE division counted as one op).
QSGD_ELEM_OPS = {"int": 8, "imul": 2, "fp": 13}
# Serving slice: SmolLM-360M (src/repro_torch/configs/smollm_360m.py).
# The flash kernel's bound counts 4·hd flops per allowed (query, key) pair
# at the bf16 tensor-core rate (data sheet, dense) and q, k, v, out once.
BF16_FLOPS_PER_S = 989e12
SERVE_ARCH = "smollm-360m"
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 4, 16384, 32
SERVE_CAPACITY = SERVE_PROMPT + SERVE_GEN + 8          # 16 424 slots
PARITY_LAYERS, PARITY_PROMPT, PARITY_GEN = 2, 8448, 4
PARITY_CAPACITY = PARITY_PROMPT + PARITY_GEN + 8       # 8460 slots
# Card against CPU, float32: the two sum in other orders over width 960
# and 8448 keys, and their cos/sin differ by ulps at positions up to
# 8451; the logits are of magnitude ≈ 3, so 1e-3 is far above sum-order
# noise (≈ 1e-5) and far below a wrong mask or position (≈ 1e-1).
PARITY_ATOL = 1e-3
# bf16, kernels against the plain version, both on the card: each flash
# output may differ by one bf16 ulp (≤ 2^-8 relative) in ≤ 1% of its
# elements, and two bf16 layers and the tied logits carry such flips on;
# 5% of the largest logit (~12 ulps at that scale) admits that and
# refuses a wrong head, mask or position, which moves logits by their
# own magnitude.
BF16_PARITY_RTOL = 0.05
# The MoE, SSM and hybrid families (phase 17).  Card against CPU: the
# reduced configs (float32; the prompt and cache of phase 9), Qwen3-MoE
# also with two experts a token so that the capacity drops.  Then bf16 at
# full width, batch 1, the serve phase's prompt, decode steps and cache:
# name -> layers served (None: all; Jamba's 52B do not fit one card, so 2
# of its 4 periods).
FAMILY_PARITY = (("qwen3-moe-30b-a3b", {}),
                 ("qwen3-moe-30b-a3b", {"experts_per_token": 2}),
                 ("falcon-mamba-7b", {}), ("jamba-v0.1-52b", {}))
FAMILY_SERVE = (("qwen3-moe-30b-a3b", None), ("falcon-mamba-7b", None),
                ("jamba-v0.1-52b", 16))
FAMILY_BATCH = 1
# Training slice: SmolLM-360M through launch/train.py (rademacher, k = 1).
TRAIN_ARCH = "smollm-360m"
TRAIN_CLIENTS, TRAIN_STEPS, TRAIN_PER_STEP, TRAIN_SEQ = 4, 2, 1, 4096
TRAIN_LR, TRAIN_ROUNDS = 0.05, 3          # timed rounds, after one warm-up
TRAIN_PARITY_LAYERS, TRAIN_PARITY_SEQ = 2, 512
# Card against CPU, float32, one round.  The loss (≈ 10.8) differs only by
# sum order (cuBLAS against the CPU's GEMMs, the embedding's atomic
# scatter-add in the backward): 1e-4 is far above that (≈ 1e-6) and far
# below a wrong gradient.  Each r sums d products of δ = ψ_S − x, whose
# elements each of the S local steps may round one float32 ulp apart
# (≤ 2⁻²⁴|w|, random signs over d elements, so ~2⁻²⁴·‖x‖₂ in all); the
# limit is 16 times S of those plus 1e-4·|r| for the gradients' sum order.
# The new params may then differ by Σₙ|Δrₙ|/N (each element moves by
# Σ rₙvₙ/N, |v| = 1) plus 1e-6.
TRAIN_LOSS_ATOL, TRAIN_R_ULPS, TRAIN_R_RTOL = 1e-4, 16, 1e-4
# Training above the 8192-token threshold (C2): 2 layers, float32, one
# sequence of 8448 tokens.  The blocked online softmax and the plain
# softmax over all keys differ only in rounding (≈ 1e-6 relative), so the
# loss within 1e-5 and each gradient within 1e-4 of its leaf's largest
# |gradient|; a lost chunk or a wrong mask moves them by far more.
TRAIN_LONG_SEQ, TRAIN_LONG_LOSS_ATOL, TRAIN_LONG_GRAD_RTOL = 8448, 1e-5, 1e-4
# Phase 21: the mesh train step (N = 2, S = 1, a global batch of 4 × 4096),
# on meshes of four entries on the one card.
MESH_CLIENTS, MESH_STEPS, MESH_BATCH = 2, 1, 4
MESH_SHAPES = ((1, 4), (2, 2))
# Its float32 (2, 2) round against the float32 unsharded round: two data
# groups sum the gradients in another order (≈ 1e-7 of r), and so do the
# shards' partial encodes; the limits are the card tests' float32 ones.
MESH_F32_LOSS_ATOL, MESH_F32_R_RTOL, MESH_F32_PARAM_SLACK = 1e-4, 1e-5, 1e-6
# Phase 23: the client-parallel step on a (2, 2) mesh (N = 2, S = 2, 1 × 4096
# a step: a client a data row).
MESH_CP_CLIENTS, MESH_CP_STEPS = 2, 2
# The flash kernels' names in the report, by flash_route's route.
FLASH_KERNELS = {"prefill": "flash_prefill", "decode": "flash_decode",
                 "f32": "flash_attention"}


class Smoke:
    def __init__(self, torch):
        self.torch = torch
        self.dev = torch.device("cuda")
        self.gen = torch.Generator(device=self.dev).manual_seed(0)
        self.errs = {"encode": 0.0, "fused": 0.0, "rec": 0.0, "qsgd": 0.0,
                     **dict.fromkeys(FLASH_KERNELS.values(), 0.0)}
        self.enc_ratio = 0.0     # largest encode error / its tolerance
        self.norm_ratio = 0.0    # largest QSGD tree norm error / its tolerance
        self.checks = 0
        self.group = ""
        # (group, kernel, family) -> [checks, max err, bitwise, max err over
        # its limit, max share of elements changed]; the last two for flash
        self.stats = {}

    # ---- inputs ----

    def randn(self, *shape):
        return self.torch.randn(shape, generator=self.gen, device=self.dev)

    def seeds(self, n):
        return self.torch.randint(0, 1 << 32, (n,), generator=self.gen,
                                  device=self.dev, dtype=self.torch.int64)

    # ---- checks ----

    def check_encode(self, x, seeds, tag, lo, hi, family, masked, ro=0, co=0,
                     orig_cols=None, what=""):
        from repro_torch.kernels.seeded_projection import (
            encode_tolerance,
            project_blocks,
            project_blocks_plain,
        )
        torch = self.torch
        got = project_blocks(x, seeds, tag, lo, hi, family, masked, ro, co,
                             orig_cols)
        again = project_blocks(x, seeds, tag, lo, hi, family, masked, ro, co,
                               orig_cols)
        want = project_blocks_plain(x, seeds, tag, lo, hi, family, masked, ro,
                                    co, orig_cols, dtype=torch.float64)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"encode not deterministic: {what}")
        err = (got.double() - want).abs()
        ratio = float((err / encode_tolerance(x, family)).max())
        if not ratio <= 1.0 or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"encode disagrees: {what} max err "
                                 f"{float(err.max())}, {ratio} of its tolerance")
        self.enc_ratio = max(self.enc_ratio, ratio)
        self._record("encode", family, float(err.max()), False)

    def check_fused(self, x2d, seeds, rs, tag, scale, family, lo, hi, masked,
                    ro=0, co=0, orig_cols=None, what=""):
        from repro_torch.kernels.reconstruct_apply import (
            fused_apply_plain,
            fused_reconstruct_apply,
            pad_cohort,
        )
        torch = self.torch
        got = fused_reconstruct_apply(x2d, seeds, rs, tag, scale, family, lo=lo,
                                      hi=hi, masked=masked, row_offset=ro,
                                      col_offset=co, orig_cols=orig_cols)
        sp, rp = pad_cohort(seeds, rs * torch.tensor(scale, dtype=torch.float32,
                                                     device=self.dev))
        want = fused_apply_plain(x2d, sp, rp, tag, lo, hi, family, masked, ro,
                                 co, orig_cols)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        ok = _decode_agrees(family, got, want)
        if not ok or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"fused disagrees: {what} max err {err}")
        self._record("fused", family, err, bool(torch.equal(got, want)))

    def check_rec(self, x2d, seeds, rs, tag, scale, family, lo, hi, masked,
                  ro=0, co=0, orig_cols=None, what=""):
        from repro_torch.kernels.seeded_reconstruct import (
            reconstruct_apply_clients,
            reconstruct_plain,
        )
        torch = self.torch
        got = reconstruct_apply_clients(x2d, seeds, rs, tag, scale, family,
                                        lo=lo, hi=hi, masked=masked,
                                        row_offset=ro, col_offset=co,
                                        orig_cols=orig_cols)
        want = reconstruct_plain(x2d, seeds, rs, tag, scale, lo, hi, family,
                                 masked, ro, co, orig_cols)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        ok = _decode_agrees(family, got, want)
        if not ok or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"rec disagrees: {what} max err {err}")
        self._record("rec", family, err, bool(torch.equal(got, want)))

    def check_qsgd(self, x, seeds, bits, what=""):
        from repro_torch.kernels.qsgd_quant import qsgd_quantize, qsgd_quantize_plain
        torch = self.torch
        n = x.shape[0]
        norms = torch.linalg.vector_norm(x.reshape(n, -1).float(), dim=1)
        norms = torch.where(norms == 0, torch.ones_like(norms), norms)
        levels = (1 << (bits - 1)) - 1
        q, lv = qsgd_quantize(x, seeds, norms, levels, True, True)
        qp, lp = qsgd_quantize_plain(x, seeds, norms, levels, True, True)
        torch.cuda.synchronize()
        err = float((q.float() - qp.float()).abs().max())
        ok = q.dtype == x.dtype and torch.equal(q, qp) and torch.equal(lv, lp)
        if not ok or not bool(torch.isfinite(q).all()):
            raise AssertionError(f"qsgd disagrees: {what} max err {err}, "
                                 f"levels equal {torch.equal(lv, lp)}")
        self._record("qsgd", f"bits={bits}", err, True)

    def check_qsgd_tree(self, leaves, seeds, bits, what=""):
        """``qsgd_tree`` (the norm pass and one quantize launch per group of
        64 leaves) bitwise against ``qsgd_tree_plain`` given the kernel's own
        norms (q and the payload); its norms within ``norm_tolerance`` of the
        float64 norm (a zero leaf's exactly 1) and the same bits on a rerun."""
        from repro_torch.kernels.qsgd_quant import (
            norm_tolerance,
            qsgd_tree,
            qsgd_tree_plain,
        )
        from repro_torch.kernels.tree import MAX_TREE_LEAVES
        torch = self.torch
        n, levels = seeds.shape[0], (1 << (bits - 1)) - 1
        before = _totals()["qsgd.launches"]
        q, pay, norms = qsgd_tree(leaves, seeds, levels, want_q=True, want_levels=True)
        launches = _totals()["qsgd.launches"] - before
        q2, pay2, norms2 = qsgd_tree(leaves, seeds, levels, want_q=True,
                                     want_levels=True)
        torch.cuda.synchronize()
        groups = -(-len(leaves) // MAX_TREE_LEAVES)
        same = (torch.equal(pay, pay2) and torch.equal(norms, norms2)
                and all(torch.equal(a, b) for a, b in zip(q, q2)))
        if launches != 2 * groups or not same:
            raise AssertionError(f"qsgd tree: {launches} launches for {groups} "
                                 f"groups, or not deterministic: {what}")
        qp, pp, _ = qsgd_tree_plain(leaves, seeds, levels, want_q=True,
                                    want_levels=True, norms=norms.contiguous())
        ok = torch.equal(pay, pp) and all(
            a.dtype == x.dtype and torch.equal(a, b) for a, b, x in zip(q, qp, leaves))
        err = max(float((a.float() - b.float()).abs().max()) for a, b in zip(q, qp))
        if not ok or not all(bool(torch.isfinite(a).all()) for a in q):
            raise AssertionError(f"qsgd tree disagrees: {what} max err {err}, "
                                 f"payload equal {torch.equal(pay, pp)}")
        for i, x in enumerate(leaves):
            exact = torch.linalg.vector_norm(x.double().reshape(n, -1), dim=1)
            dev = (norms[:, i].double() - exact).abs()
            zero = exact == 0
            if not (bool((norms[:, i][zero] == 1).all())
                    and bool((dev[~zero] <= norm_tolerance(x)[~zero]).all())):
                raise AssertionError(f"qsgd tree norms off: {what} leaf {i}")
            if (~zero).any():
                self.norm_ratio = max(self.norm_ratio, float(
                    (dev[~zero] / norm_tolerance(x)[~zero]).max()))
        self._record("qsgd", f"bits={bits}", err, True)

    def check_flash(self, b, s, t, h, kh, hd, dtype, window=0, qpos=None,
                    kpos=None):
        """Kernel against plain version on the rows with an allowed key."""
        torch = self.torch
        q = self.randn(b, s, h, hd).to(dtype)
        k = self.randn(b, t, kh, hd).to(dtype)
        v = self.randn(b, t, kh, hd).to(dtype)
        i32 = dict(dtype=torch.int32, device=self.dev)
        qpos = torch.arange(t - s, t, **i32) if qpos is None else qpos.to(**i32)
        kpos = torch.arange(t, **i32) if kpos is None else kpos.to(**i32)
        self.check_flash_on(q, k, v, qpos, kpos, window)

    def check_flash_on(self, q, k, v, qpos, kpos, window=0):
        """``check_flash`` on given inputs (a model's own q, k, v)."""
        from repro_torch.kernels.flash_attention import (
            allowed_mask,
            flash_agrees,
            flash_attention,
            flash_attention_plain,
            flash_compare,
            flash_route,
        )
        torch = self.torch
        (b, s, h, hd), (t, kh), dtype = q.shape, k.shape[1:3], q.dtype
        kernel = FLASH_KERNELS[flash_route(s, h, kh, dtype)]
        got = flash_attention(q, k, v, qpos, kpos, causal=True, window=window)
        want = flash_attention_plain(q, k, v, qpos, kpos, causal=True,
                                     window=window)
        torch.cuda.synchronize()
        rows = allowed_mask(qpos, kpos, True, window).any(dim=1)
        name = str(dtype).removeprefix("torch.")
        g, w = got[:, rows], want[:, rows]
        what = (f"{kernel} B={b} S={s} T={t} H={h} K={kh} hd={hd} {name} "
                f"window={window}")
        if not rows.any():
            raise AssertionError(f"flash check without an allowed row: {what}")
        err, ratio, changed = flash_compare(g, w)
        if not (flash_agrees(g, w) and bool((got[:, ~rows] == 0).all())):
            raise AssertionError(f"flash disagrees: {what} max err {err}, "
                                 f"{ratio} of its limit, {changed} of the "
                                 "elements changed")
        self._record(kernel, f"{name} hd={hd}", err, bool(torch.equal(g, w)),
                     ratio, changed)

    def check_tree_encode(self, deltas, seeds, family, k, mode, what=""):
        """``ops.project_tree_kernel`` (one tree launch and its reduction per
        group of 64 leaves) against the tree's plain version summed in
        float64, within ``tree_encode_tolerance``; the same bits on a rerun."""
        from repro_torch.core.prng import Distribution
        from repro_torch.core.projection import ProjectionMode
        from repro_torch.core.tree import tree_leaves
        from repro_torch.kernels import ops
        from repro_torch.kernels.seeded_projection import (
            project_tree_plain,
            tree_encode_tolerance,
        )
        from repro_torch.kernels.tree import tree_plan
        torch = self.torch
        leaves = tree_leaves(deltas)
        n = leaves[0].shape[0]
        mode = ProjectionMode(mode)
        plan = tree_plan("encode", [tuple(x.shape[1:]) for x in leaves],
                         [x.dtype for x in leaves], k, mode, self.dev)
        before = _totals()["encode.launches"]
        got = ops.project_tree_kernel(deltas, seeds, Distribution(family), k, mode)
        again = ops.project_tree_kernel(deltas, seeds, Distribution(family), k, mode)
        launches = _totals()["encode.launches"] - before
        want = project_tree_plain(leaves, seeds, plan, family, dtype=torch.float64)
        torch.cuda.synchronize()
        if launches != 4 * len(plan.groups) or not torch.equal(got, again):
            raise AssertionError(f"tree encode: {launches} launches for "
                                 f"{len(plan.groups)} groups, or not "
                                 f"deterministic: {what}")
        views = [x.reshape(n, ll.rows, ll.cols) for ll, x in zip(plan.layout, leaves)]
        err = (got.double() - want).abs()
        ratio = float((err / tree_encode_tolerance(views, family)).max())
        if not ratio <= 1.0 or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"tree encode disagrees: {what} max err "
                                 f"{float(err.max())}, {ratio} of its tolerance")
        self.enc_ratio = max(self.enc_ratio, ratio)
        self._record("encode", family, float(err.max()), False)

    def check_tree_close(self, params, seeds, rs, family, k, mode, what=""):
        """``ops.server_update_fused`` (one tree launch per group of 64
        leaves) against the plain tree close, leaf by leaf."""
        from repro_torch.core.prng import Distribution
        from repro_torch.core.projection import ProjectionMode
        from repro_torch.core.tree import tree_leaves
        from repro_torch.kernels import ops
        from repro_torch.kernels.reconstruct_apply import fused_tree_plain
        from repro_torch.kernels.tree import tree_plan
        torch = self.torch
        mode = ProjectionMode(mode)
        leaves = tree_leaves(params)
        plan = tree_plan("close", [tuple(x.shape) for x in leaves],
                         [x.dtype for x in leaves], k, mode, self.dev)
        before = _totals()["close.launches"]
        got = tree_leaves(ops.server_update_fused(params, rs, seeds, 0.9,
                                                  Distribution(family), mode=mode))
        launches = _totals()["close.launches"] - before
        frs, scale = ops.fold_upload_weights(rs, 0.9, None, mode, None)
        want = fused_tree_plain(leaves, seeds, frs, scale, plan, family)
        torch.cuda.synchronize()
        if launches != len(plan.groups):
            raise AssertionError(f"tree close: {launches} launches for "
                                 f"{len(plan.groups)} groups: {what}")
        err, same = 0.0, True
        for g, w in zip(got, want):
            err = max(err, float((g.float() - w.float()).abs().max()))
            same = same and bool(torch.equal(g, w))
            if not _decode_agrees(family, g, w) or not bool(torch.isfinite(g).all()):
                raise AssertionError(f"tree close disagrees: {what} max err {err}")
        self._record("fused", family, err, same)

    def check_tree_decode(self, params, seeds, rs, family, k, mode, rounding,
                          what=""):
        """``ops.server_update_kernel`` (one decode tree launch per group of
        64 leaves) against the plain tree decode, leaf by leaf."""
        from repro_torch.core.prng import Distribution
        from repro_torch.core.projection import ProjectionMode
        from repro_torch.core.tree import tree_leaves
        from repro_torch.kernels import ops
        from repro_torch.kernels.seeded_reconstruct import reconstruct_tree_plain
        from repro_torch.kernels.tree import tree_plan
        torch = self.torch
        mode = ProjectionMode(mode)
        leaves = tree_leaves(params)
        n = rs.shape[0]
        plan = tree_plan("decode", [tuple(x.shape) for x in leaves],
                         [x.dtype for x in leaves], k, mode, self.dev)
        before = _totals()["decode.launches"]
        got = tree_leaves(ops.server_update_kernel(params, rs, seeds, 0.9,
                                                   Distribution(family), mode=mode,
                                                   per_client_rounding=rounding))
        launches = _totals()["decode.launches"] - before
        frs, scale = ops.fold_upload_weights(rs, 0.9, None, mode, None)
        scale, div = (0.9, float(n)) if rounding else (scale, 1.0)
        want = reconstruct_tree_plain(leaves, seeds, frs, scale, div, plan, family,
                                      rounding)
        torch.cuda.synchronize()
        if launches != len(plan.groups):
            raise AssertionError(f"tree decode: {launches} launches for "
                                 f"{len(plan.groups)} groups: {what}")
        err, same = 0.0, True
        for g, w in zip(got, want):
            err = max(err, float((g.float() - w.float()).abs().max()))
            same = same and bool(torch.equal(g, w))
            if not _decode_agrees(family, g, w) or not bool(torch.isfinite(g).all()):
                raise AssertionError(f"tree decode disagrees: {what} max err {err}")
        self._record("rec", family, err, same)

    def _record(self, kernel, family, err, bitwise, ratio=0.0, changed=0.0):
        self.errs[kernel] = max(self.errs[kernel], err)
        self.checks += 1
        st = self.stats.setdefault((self.group, kernel, family),
                                   [0, 0.0, True, 0.0, 0.0])
        st[0] += 1
        st[1] = max(st[1], err)
        st[2] = st[2] and bitwise
        st[3] = max(st[3], ratio)
        st[4] = max(st[4], changed)

    def report(self):
        """One line per (kernel, family) of the current group."""
        for (group, kernel, family), (n, err, bitwise, ratio,
                                      changed) in self.stats.items():
            if group == self.group:
                if kernel == "encode":
                    what = ("max |kernel - float64 plain| "
                            f"{err!r}, same bits on every rerun")
                elif kernel == "qsgd":
                    what = (f"max |kernel q - plain q| {err!r}, levels and q "
                            "bitwise equal to plain")
                elif kernel in FLASH_KERNELS.values():
                    what = (f"max |kernel - plain| {err!r}, at most {ratio!r} "
                            f"of its limit, at most {changed!r} of a check's "
                            f"elements changed, bitwise equal to plain: {bitwise}")
                else:
                    what = (f"max |kernel - plain| {err!r}, bitwise equal to "
                            f"plain: {bitwise}")
                print(f"kernels: {group}: {kernel} {family}: {n} checks, {what}")
        sys.stdout.flush()

    # ---- timing ----

    def time_ms(self, fn, reps=20, warmup=2):
        torch = self.torch
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps


def _decode_agrees(family, got, want):
    """Close and decode against their plain version: bitwise for the ±1/±2
    families; gaussian within rtol/atol 1e-5 of the float32 values, plus
    one bf16 ulp (2⁻⁷·|y|) on a bf16 leaf, where those round apart."""
    import torch

    if got.dtype != want.dtype:
        return False
    if family in EXACT:
        return torch.equal(got, want)
    rtol = 1e-5 + (2.0 ** -7 if got.dtype == torch.bfloat16 else 0.0)
    return bool(torch.allclose(got.float(), want.float(), rtol=rtol, atol=1e-5))


def _bound_ms(nbytes, shapes, n, k):
    """Least time: bytes over HBM, or each op class over its own rate."""
    d = sum(r * c for r, c in shapes)
    rows = sum(r for r, _ in shapes)
    ops = {c: n * k * (ELEM_OPS[c] * d + ROW_OPS[c] * rows) for c in ELEM_OPS}
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 1e3 * max(ops["int"] / INT32_OPS_PER_S, ops["imul"] / INT32_OPS_PER_S,
                      ops["fp"] / FP32_OPS_PER_S, sum(ops.values()) / ISSUE_PER_S)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _encode_bound(shapes, n, k, elem=4):
    """x read once (``elem`` bytes per element), r written."""
    d = sum(r * c for r, c in shapes)
    return _bound_ms(elem * n * d + 4 * n * k * len(shapes), shapes, n, k)


def _fused_bound(shapes, n, k, elem=4):
    """x read and y written once (``elem`` bytes each), seeds and rs."""
    d = sum(r * c for r, c in shapes)
    return _bound_ms(2 * elem * d + len(shapes) * n * (4 + 4 * k), shapes, n, k)


# The per-client decode does the fused close's work in another order.
_rec_bound = _fused_bound


def _qsgd_bound(shapes, n, outputs, elem=4, written=None):
    """Bytes: x (``elem`` bytes an element) read by the norm pass and by the
    kernel, ``outputs`` float32 arrays written (or ``written`` bytes an
    element), seeds and norms; ops: QSGD_ELEM_OPS per element."""
    d = sum(r * c for r, c in shapes)
    written = 4 * outputs if written is None else written
    nbytes = n * d * (2 * elem + written) + len(shapes) * n * (8 + 4)
    ops = {c: n * d * QSGD_ELEM_OPS[c] for c in QSGD_ELEM_OPS}
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 1e3 * max(ops["int"] / INT32_OPS_PER_S, ops["imul"] / INT32_OPS_PER_S,
                      ops["fp"] / FP32_OPS_PER_S, sum(ops.values()) / ISSUE_PER_S)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_device(torch):
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    smi_line = smi.splitlines()[0]
    print(f"device: {name} count={count} torch={torch.__version__} "
          f"cuda={torch.version.cuda}")
    print(smi_line, flush=True)
    return name, count, smi_line


def phase_build():
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    results = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.3f} s wall for "
          f"{len(results)} sources, in parallel")
    for name, res in results.items():
        print(f"build: {name}: {res.seconds:.3f} s -> {res.path.name}")
        fn = None
        for line in res.log.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                fn = m.group(1)
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            spills = m.groups() if m else None
            if spills and fn:
                print(f"ptxas: {fn}: spill stores {spills[0]} B, loads {spills[1]} B")
            m = re.search(r"Used (\d+) registers", line)
            if m and fn:
                print(f"ptxas: {fn}: {m.group(1)} registers")
    sys.stdout.flush()


def phase_kernels(s: Smoke):
    """Kernel against plain version at the main path's and the large shapes."""
    import torch

    from repro_torch.core.projection import ProjectionMode
    from repro_torch.kernels.ops import leaf_block_bounds

    t0 = time.perf_counter()
    mlp = [(1, 24), (1, 12), (1, 10), (64, 24), (24, 12), (12, 10)]
    total = sum(r * c for r, c in mlp)

    def bounds(offset, size, tot, k, mode):
        lo, hi = leaf_block_bounds(offset, size, tot, k, ProjectionMode(mode))
        return (torch.tensor(lo, dtype=torch.float32, device=s.dev),
                torch.tensor(hi, dtype=torch.float32, device=s.dev))

    # MLP leaves: every family, k ∈ {1, FULL 8, BLOCK 8}, cohorts 20 and 1000.
    s.group = "MLP leaves (k=1, FULL 8, BLOCK 8; N=20, 1000)"
    for family in FAMILIES:
        for k, mode in ((1, "full"), (8, "full"), (8, "block")):
            masked = mode == "block"
            for n in (20, 1000):
                offset = 0
                seeds = s.seeds(n)
                rs = s.randn(n, k)
                for tag, (rows, cols) in enumerate(mlp):
                    lo, hi = bounds(offset, rows * cols, total, k, mode)
                    what = f"mlp {family} k={k} {mode} n={n} leaf={rows}x{cols}"
                    s.check_encode(s.randn(n, rows, cols), seeds, tag, lo, hi,
                                   family, masked, what=what)
                    s.check_fused(s.randn(rows, cols), seeds, rs, tag, 1.0 / n,
                                  family, lo, hi, masked, what=what)
                    offset += rows * cols
    s.report()

    # Nonzero runtime row/col offsets (a shard of a wider leaf).
    s.group = "row/col offsets (300x700 of a 1000-col leaf, BLOCK 3)"
    for family in FAMILIES:
        lo = torch.tensor([0.0, 4e5, 9e5], device=s.dev)
        hi = torch.tensor([4e5, 9e5, 4e6], device=s.dev)
        s.check_encode(s.randn(20, 300, 700), s.seeds(20), 4, lo, hi, family,
                       True, 960, 33, 1000, what=f"offsets {family}")
        s.check_fused(s.randn(300, 700), s.seeds(1000), s.randn(1000, 3), 4,
                      0.001, family, lo, hi, True, 960, 33, 1000,
                      what=f"offsets {family}")
    s.report()

    # SmolLM-360M-sized leaves.
    s.group = f"large leaf {LARGE} (k=1, FULL 8; N=2 encode, 20/1000 close)"
    rows, cols = LARGE
    x = s.randn(2, rows, cols)
    for family in FAMILIES:
        for k in (1, 8):
            lo, hi = bounds(0, rows * cols, rows * cols, k, "full")
            what = f"large {family} k={k} full"
            s.check_encode(x, s.seeds(2), 9, lo, hi, family, False, what=what)
            s.check_fused(x[0], s.seeds(20), s.randn(20, k), 9, 0.05, family,
                          lo, hi, False, what=what + " n=20")
    lo, hi = bounds(0, rows * cols, rows * cols, 1, "full")
    s.check_fused(x[0], s.seeds(1000), s.randn(1000, 1), 9, 0.001, "rademacher",
                  lo, hi, False, what="large rademacher k=1 n=1000")
    del x
    s.report()
    s.group = f"block leaf {LARGE_BLOCK} (BLOCK 8; N=4 encode, 20/1000 close)"
    rows, cols = LARGE_BLOCK
    lo, hi = bounds(123_456, rows * cols, 3 * rows * cols, 8, "block")
    for family in FAMILIES:
        what = f"block-leaf {family} k=8 block"
        s.check_encode(s.randn(4, rows, cols), s.seeds(4), 5, lo, hi, family,
                       True, what=what)
        for n in (20, 1000):
            s.check_fused(s.randn(rows, cols), s.seeds(n), s.randn(n, 8), 5,
                          1.0 / n, family, lo, hi, True, what=f"{what} n={n}")
    s.report()
    torch.cuda.empty_cache()
    print(f"kernels: all {s.checks} checks ok in "
          f"{time.perf_counter() - t0:.1f} s; max |err| encode "
          f"{s.errs['encode']!r} (at most {s.enc_ratio!r} of its tolerance), "
          f"fused {s.errs['fused']!r}", flush=True)


def phase_kernels_runtime(s: Smoke):
    """The runtime slice's kernels against their plain versions."""
    import torch

    from repro_torch.core.projection import ProjectionMode
    from repro_torch.kernels.ops import leaf_block_bounds

    t0 = time.perf_counter()
    total = sum(r * c for r, c in MLP)

    def bounds(offset, size, tot, k, mode):
        lo, hi = leaf_block_bounds(offset, size, tot, k, ProjectionMode(mode))
        return (torch.tensor(lo, dtype=torch.float32, device=s.dev),
                torch.tensor(hi, dtype=torch.float32, device=s.dev))

    # Per-client decode: every family, k ∈ {1, FULL 8, BLOCK 8}, cohorts
    # 20, 33 (a ragged 32-client chunk) and 1000, weights folded in.
    s.group = "per-client decode, MLP leaves (k=1, FULL 8, BLOCK 8; N=20, 33, 1000)"
    for family in FAMILIES:
        for k, mode in ((1, "full"), (8, "full"), (8, "block")):
            for n in (20, 33, 1000):
                offset = 0
                seeds = s.seeds(n)
                rs = s.randn(n, k) * s.randn(n, 1).abs()
                for tag, (rows, cols) in enumerate(MLP):
                    lo, hi = bounds(offset, rows * cols, total, k, mode)
                    s.check_rec(s.randn(rows, cols), seeds, rs, tag, 1.0 / n,
                                family, lo, hi, mode == "block",
                                what=f"mlp {family} k={k} {mode} n={n} "
                                     f"leaf={rows}x{cols}")
                    offset += rows * cols
    s.report()
    s.group = "per-client decode, row/col offsets (300x700 of a 1000-col leaf, BLOCK 3)"
    lo = torch.tensor([0.0, 4e5, 9e5], device=s.dev)
    hi = torch.tensor([4e5, 9e5, 4e6], device=s.dev)
    for family in FAMILIES:
        s.check_rec(s.randn(300, 700), s.seeds(1000), s.randn(1000, 3), 4,
                    0.001, family, lo, hi, True, 960, 33, 1000,
                    what=f"offsets {family}")
    s.report()
    s.group = f"per-client decode, large leaf {LARGE} (k=1; N=20 all, 1000 rademacher)"
    rows, cols = LARGE
    x = s.randn(rows, cols)
    lo, hi = bounds(0, rows * cols, rows * cols, 1, "full")
    for family in FAMILIES:
        s.check_rec(x, s.seeds(20), s.randn(20, 1), 9, 0.05, family, lo, hi,
                    False, what=f"large {family} k=1 n=20")
    s.check_rec(x, s.seeds(1000), s.randn(1000, 1), 9, 0.001, "rademacher",
                lo, hi, False, what="large rademacher k=1 n=1000")
    del x
    s.report()
    s.group = f"per-client decode, block leaf {LARGE_BLOCK} (BLOCK 8; N=20, 1000)"
    rows, cols = LARGE_BLOCK
    lo, hi = bounds(123_456, rows * cols, 3 * rows * cols, 8, "block")
    for family in FAMILIES:
        for n in (20, 1000):
            s.check_rec(s.randn(rows, cols), s.seeds(n), s.randn(n, 8), 5,
                        1.0 / n, family, lo, hi, True,
                        what=f"block-leaf {family} k=8 n={n}")
    s.report()

    # QSGD: bits 2, 4, 8 at the MLP leaves for the runtime's cohort of
    # 1000, a leaf of zeros, and the large leaf for 16 clients; one leaf at
    # a time with the norms given, then the tree entry with its own norms.
    s.group = "qsgd (bits 2, 4, 8; MLP leaves N=1000, a zero leaf, large leaf N=16)"
    for bits in (2, 4, 8):
        for rows, cols in MLP:
            x = s.randn(1000, rows, cols) * 0.01
            x[7] = 0.0
            s.check_qsgd(x, s.seeds(1000), bits, what=f"mlp {rows}x{cols} b={bits}")
        s.check_qsgd(torch.zeros((4, 64, 24), device=s.dev), s.seeds(4), bits,
                     what=f"zero leaf b={bits}")
    x = s.randn(16, *LARGE) * 0.01
    for bits in (2, 4, 8):
        s.check_qsgd(x, s.seeds(16), bits, what=f"large b={bits}")
    s.report()
    s.group = ("qsgd tree entry, norms in the kernel (bits 2, 4, 8; the MLP tree "
               "N=1000 and 256 with a zero client, a zero tree, large leaf N=16)")
    for bits in (2, 4, 8):
        for n in (1000, 256):
            tree = [s.randn(n, r, c) * 0.01 for r, c in MLP]
            for leaf in tree:
                leaf[7] = 0.0
            s.check_qsgd_tree(tree, s.seeds(n), bits, what=f"mlp tree n={n} b={bits}")
        s.check_qsgd_tree([torch.zeros((4, r, c), device=s.dev) for r, c in MLP],
                          s.seeds(4), bits, what=f"zero tree b={bits}")
        s.check_qsgd_tree([x], s.seeds(16), bits, what=f"large b={bits}")
    del x
    s.report()
    torch.cuda.empty_cache()
    print(f"kernels (runtime slice): all checks ok in "
          f"{time.perf_counter() - t0:.1f} s; max |err| rec {s.errs['rec']!r}, "
          f"qsgd {s.errs['qsgd']!r}; qsgd tree norms at most {s.norm_ratio!r} of "
          "their tolerance", flush=True)


def _tree_shapes(n_leaves):
    """The MLP's leaf shapes, repeated to ``n_leaves`` leaves, with a wide
    SmolLM-width leaf every seventh (ragged and 16-byte-multiple columns)."""
    shapes = [(24,), (12,), (10,), (64, 24), (24, 12), (12, 10), (33, 960)]
    return [shapes[i % len(shapes)] for i in range(n_leaves)]


def _rand_tree(s: Smoke, shapes, dtype, lead=()):
    return {f"l{i:03d}": (s.randn(*lead, *sh) * 0.1).to(dtype)
            for i, sh in enumerate(shapes)}


def phase_tree_kernels(s: Smoke):
    """The tree launches of the encode and the fused close against their
    plain versions; the narrow leaves past the old launch grids (C1)."""
    import torch

    t0 = time.perf_counter()
    n0 = s.checks
    s.group = ("tree launches, the MLP tree (6 leaves, one launch): float32 and "
               "bf16, all families, k=1, FULL 8, BLOCK 8; encode N=20, close "
               "N=20 (and N=1000 at k=1)")
    mlp = [(24,), (12,), (10,), (64, 24), (24, 12), (12, 10)]
    for dtype in (torch.float32, torch.bfloat16):
        for family in FAMILIES:
            for k, mode in ((1, "full"), (8, "full"), (8, "block")):
                what = f"mlp tree {str(dtype)[6:]} {family} k={k} {mode}"
                s.check_tree_encode(_rand_tree(s, mlp, dtype, (20,)), s.seeds(20),
                                    family, k, mode, what)
                params = _rand_tree(s, mlp, dtype)
                for n in ((20, 1000) if k == 1 else (20,)):
                    s.check_tree_close(params, s.seeds(n), s.randn(n, k), family,
                                       k, mode, f"{what} n={n}")
    s.report()
    s.group = ("tree launches, a 70-leaf tree (two launches: the table holds 64): "
               "float32 and bf16, rademacher and hadamard, FULL 8 and BLOCK 8; "
               "encode and close N=20")
    shapes = _tree_shapes(70)
    for dtype in (torch.float32, torch.bfloat16):
        for family in ("rademacher", "hadamard"):
            for k, mode in ((8, "full"), (8, "block")):
                what = f"70-leaf tree {str(dtype)[6:]} {family} k={k} {mode}"
                s.check_tree_encode(_rand_tree(s, shapes, dtype, (20,)), s.seeds(20),
                                    family, k, mode, what)
                s.check_tree_close(_rand_tree(s, shapes, dtype), s.seeds(20),
                                   s.randn(20, k), family, k, mode, what)
    s.report()
    s.group = ("tree launches of the per-client decode, the MLP tree (one launch, "
               "one column a thread) and a 70-leaf tree (two launches): float32 and "
               "bf16; plain (k=1, FULL 8, BLOCK 8), per-client rounding (k=1, "
               "FULL 8, BLOCK 8; the ±1/±2 families); N=20, and N=1024 at k=1")
    modes = [(1, "full", False), (8, "full", False), (8, "block", False),
             (1, "full", True), (8, "full", True), (8, "block", True)]
    for dtype in (torch.float32, torch.bfloat16):
        for family in FAMILIES:
            params = _rand_tree(s, mlp, dtype)
            for k, mode, rounding in modes:
                if rounding and family not in EXACT:
                    continue    # a gaussian ulp may round a client's sum apart
                what = (f"mlp tree decode {str(dtype)[6:]} {family} k={k} {mode} "
                        f"rounding={rounding}")
                for n in ((20, 1024) if k == 1 else (20,)):
                    s.check_tree_decode(params, s.seeds(n), s.randn(n, k), family, k,
                                        mode, rounding, f"{what} n={n}")
        for family in ("rademacher", "hadamard"):
            params = _rand_tree(s, shapes, dtype)
            for k, mode, rounding in modes:
                s.check_tree_decode(params, s.seeds(20), s.randn(20, k), family, k,
                                    mode, rounding,
                                    f"70-leaf tree decode {str(dtype)[6:]} {family} "
                                    f"k={k} {mode} rounding={rounding}")
    s.report()
    s.group = ("narrow leaves past the old grid limits (C1): 524288x1 through "
               "the fused close and the per-client decode (N=20), 262144x2 "
               "through QSGD (N=2); float32 and bf16")
    zero = torch.zeros(1, device=s.dev)
    for dtype in (torch.float32, torch.bfloat16):
        x2d = s.randn(524_288, 1).to(dtype)
        hi = zero + float(x2d.numel())
        for family in FAMILIES:
            sd, rs = s.seeds(20), s.randn(20, 1)
            s.check_fused(x2d, sd, rs, 3, 0.05, family, zero, hi, False,
                          what=f"narrow 524288x1 {dtype} {family}")
            s.check_rec(x2d, sd, rs, 3, 0.05, family, zero, hi, False,
                        what=f"narrow 524288x1 {dtype} {family}")
        s.check_qsgd((s.randn(2, 262_144, 2) * 0.01).to(dtype), s.seeds(2), 8,
                     what=f"narrow 262144x2 {dtype}")
    s.report()
    s.group = ("qsgd tree launches: the MLP tree (N=1000, one launch and its norm "
               "pass), a 70-leaf tree (N=20, two), a 262144x2 leaf (N=2); float32 "
               "and bf16, bits 2, 4, 8; each leaf's norm as in a tree of its own")
    from repro_torch.kernels.qsgd_quant import qsgd_tree
    for dtype in (torch.float32, torch.bfloat16):
        for bits in (2, 4, 8):
            sfx = f"{str(dtype)[6:]} b={bits}"
            s.check_qsgd_tree([(s.randn(1000, r, c) * 0.01).to(dtype) for r, c in MLP],
                              s.seeds(1000), bits, what=f"mlp tree {sfx}")
            tree = [(s.randn(20, *sh) * 0.01).to(dtype) for sh in _tree_shapes(70)]
            sd = s.seeds(20)
            s.check_qsgd_tree(tree, sd, bits, what=f"70-leaf tree {sfx}")
            s.check_qsgd_tree([(s.randn(2, 262_144, 2) * 0.01).to(dtype)], s.seeds(2),
                              bits, what=f"narrow 262144x2 {sfx}")
        _, _, norms = qsgd_tree(tree, sd, 127)
        for i, leaf in enumerate(tree):
            if not torch.equal(qsgd_tree([leaf], sd, 127)[2][:, 0], norms[:, i]):
                raise AssertionError(f"qsgd tree: leaf {i}'s norm depends on the "
                                     "launch group")
    s.report()
    torch.cuda.empty_cache()
    print(f"tree kernels: all {s.checks - n0} checks ok in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


def _totals():
    """The port's counters so far (``repro_torch.obs``)."""
    from repro_torch import obs

    return obs.totals()


class Launches(dict):
    """Kernel launch counters by key (key → the port's counter name),
    read as the launches since the last :meth:`reset`."""

    def __init__(self, names):
        super().__init__(names)
        self.reset()

    def reset(self) -> None:
        self.base = _totals()

    def read(self) -> dict:
        now = _totals()
        return {k: now[c] - self.base[c] for k, c in self.items()}

    def moved(self) -> dict:
        """The counters that moved since the last reset."""
        return {k: n for k, n in self.read().items() if n}


def _kernel_fns():
    return Launches({"encode": "encode.launches", "fused": "close.launches",
                     "rec": "decode.launches", "qsgd": "qsgd.launches"})


def phase_runtime(s: Smoke):
    """run_federation on the card at 100 000 clients, cohorts of 1000."""
    import numpy as np
    import torch

    from repro_torch.data import load_digits, make_client_datasets
    from repro_torch.data import train_test_split_arrays
    from repro_torch.fed.runtime import RuntimeConfig, run_federation
    from repro_torch.models.mlp_classifier import init_mlp

    x, y = load_digits()
    xtr, ytr, xte, yte = train_test_split_arrays(x, y)
    clients = make_client_datasets(xtr, ytr, RT_SHARDS)
    fns = _kernel_fns()
    launches = dict.fromkeys(fns, 0)
    rows = {}
    for name, (over, expect) in RT_CONFIGS.items():
        cfg = RuntimeConfig(rounds=RT_ROUNDS, population=RT_POPULATION,
                            participation=RT_PARTICIPATION, eval_every=1,
                            seed=0, **over)
        params = init_mlp(seed=0, device="cuda")
        fns.reset()
        t0 = time.perf_counter()
        h = run_federation(cfg, params, clients, xte, yte, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = fns.read()
        for k in launches:
            launches[k] += got[k]
        missing = [k for k in expect if got[k] == 0]
        stray = [k for k in got if k not in expect and got[k]]
        loss = h["loss"]
        if missing or stray:
            raise AssertionError(f"runtime {name}: launches {got}, expected "
                                 f"only {expect}")
        if h["fused_path"] or not (h["cohort_size"] == 1000).all():
            raise AssertionError(f"runtime {name}: not the event-driven path "
                                 f"at cohort 1000")
        if "qsgd" in expect:
            # one tree call per chunk of cfg.client_chunk: the norm pass and
            # the quantize launch
            chunks = int(sum(-(-int(c) // cfg.client_chunk) for c in h["cohort_size"]))
            if got["qsgd"] != 2 * chunks:
                raise AssertionError(f"runtime {name}: {got['qsgd']} QSGD launches "
                                     f"for {chunks} chunks, expected 2 a chunk")
        if not np.isfinite(loss).all() or not loss[-1] < loss[0]:
            raise AssertionError(f"runtime {name}: loss did not fall: "
                                 f"{loss[0]} -> {loss[-1]}")
        applied = h["apply_s"] > 0
        rows[name] = dict(
            rounds_per_s=RT_ROUNDS / wall,
            median_apply_ms=float(np.median(h["apply_s"][applied]) * 1e3),
            launches=got, bits_per_upload=int(h["bits_per_client_per_round"]),
            loss_first=float(loss[0]), loss_last=float(loss[-1]),
            accuracy_last=float(h["accuracy"][-1]),
            replay_verified=bool(cfg.verify_replay))
        print(f"runtime: {name}: " + json.dumps(rows[name]), flush=True)

    # One round on the card against the same round on the CPU.  The
    # decode threshold is pinned on both so both take the same route.
    for name, (over, _) in RT_CONFIGS.items():
        cfg = RuntimeConfig(rounds=1, population=RT_POPULATION,
                            participation=RT_PARTICIPATION, seed=3,
                            **{**over, "kernel_cohort_threshold": 512})
        hs = {dev: run_federation(cfg, init_mlp(seed=2, device=dev), clients,
                                  xte, yte, device=dev)
              for dev in ("cuda", "cpu")}
        err = max(float((hs["cuda"]["final_params"][k].cpu()
                         - hs["cpu"]["final_params"][k]).abs().max())
                  for k in hs["cpu"]["final_params"])
        tol = 2e-6 if over.get("protocol_name") == "qsgd" else 1e-6
        if not err <= tol:
            raise AssertionError(f"runtime {name}: card round differs from "
                                 f"CPU by {err} (tolerance {tol})")
        for key in ("cum_bits", "applied", "cum_downlink_bits"):
            if not np.array_equal(hs["cuda"][key], hs["cpu"][key]):
                raise AssertionError(f"runtime {name}: {key} differs")
        print(f"runtime: {name}: one round, card vs CPU max |dparams| {err!r} "
              f"(tolerance {tol})", flush=True)
    rows.update(_phase_scheduler(clients, xte, yte, fns, launches))
    return launches, rows


def _sched_config(over, sched, rounds=SCHED_ROUNDS):
    from repro_torch.fed.costmodel import ChannelConfig
    from repro_torch.fed.runtime import RuntimeConfig, SchedulerConfig

    base = dict(rounds=rounds, population=RT_POPULATION,
                participation=RT_PARTICIPATION, seed=0, eval_every=10**6,
                downlink_mode="digest",
                channel=ChannelConfig(base_latency_s=0.02, lognormal_sigma=0.5))
    base.update(over)
    return RuntimeConfig(
        scheduler=SchedulerConfig(**sched) if sched is not None else None, **base)


def _csv_rows(path):
    import csv

    with open(REPO / path) as f:
        return {r["mode"]: r for r in csv.DictReader(f)}


def _check_modeled(name, s, h, row):
    """The modeled figures against the CSV row, to its printed digits."""
    got = dict(
        cohort=str(int(h["cohort_size"][0])), rounds=str(len(s["starts"])),
        quorum_frac=str(s["quorum_frac"]),
        period_s="" if s["period_s"] is None else str(s["period_s"]),
        max_rounds_in_flight=str(s["max_rounds_in_flight"]),
        makespan_s=f"{s['makespan_s']:.6f}",
        rounds_per_s=f"{s['rounds_per_s']:.3f}",
        clients_per_s=f"{s['clients_per_s']:.1f}",
        stale_admitted=str(s["stale_admitted"]),
        stale_dropped=str(s["stale_dropped"]),
        params_lag_max=str(s["params_lag_max"]),
        queue_peak_bytes=str(s["queue_peak_bytes"]),
        agg_state_bytes_peak=str(s["agg_state_bytes_peak"]),
        client_state_bytes=str(s["client_state_bytes"]))
    bad = {k: (v, row[k]) for k, v in got.items() if row[k] != v}
    if bad:
        raise AssertionError(f"runtime {name}: modeled figures differ from "
                             f"{SCHED_CSV} (got, csv): {bad}")


def _sched_launches(name, cfg, h, fns, expect):
    """The launches since ``fns`` was reset, held to a scheduled
    run: the encode and QSGD twice a chunk, each close kernel in
    ``expect`` once a round, and nothing outside ``expect``."""
    got = fns.read()
    chunks = int(sum(-(-int(c) // cfg.client_chunk) for c in h["cohort_size"]))
    want = {"encode": 2 * chunks, "rec": cfg.rounds, "fused": cfg.rounds,
            "qsgd": 2 * chunks}
    stray = [k for k in got if k not in expect and got[k]]
    wrong = {k: (got[k], want[k]) for k in expect if got[k] != want[k]}
    if stray or wrong:
        raise AssertionError(f"runtime {name}: launches {got}; expected only "
                             f"{expect}, (got, want) {wrong}")
    return got


def _phase_scheduler(clients, xte, yte, fns, launches):
    """The continuous-round scheduler on the card (phase 5, second half)."""
    import numpy as np
    import torch

    from repro_torch.fed.costmodel import ChannelConfig
    from repro_torch.fed.runtime import EngineCore, run_federation
    from repro_torch.models.mlp_classifier import init_mlp

    stat_keys = [k for k in EngineCore.new_history(0)
                 if k not in UNSHARED_HISTORY]
    csv_rows = _csv_rows(SCHED_CSV)
    rows, legacy_params = {}, None
    for name, (over, sched, expect, csv_mode) in SCHED_RUNS.items():
        cfg = _sched_config(over, sched)
        params = init_mlp(seed=0, device="cuda")
        fns.reset()
        t0 = time.perf_counter()
        h = run_federation(cfg, params, clients, xte, yte, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = _sched_launches(name, cfg, h, fns, expect)
        for k in launches:
            launches[k] += got[k]
        if h["fused_path"] or not (h["cohort_size"] == 1000).all():
            raise AssertionError(f"runtime {name}: not the event-driven path "
                                 f"at cohort 1000")
        loss = h["loss"][~np.isnan(h["loss"])]
        if not np.isfinite(loss).all() or not loss[-1] < loss[0]:
            raise AssertionError(f"runtime {name}: loss did not fall: "
                                 f"{loss[0]} -> {loss[-1]}")
        if sched is None:
            legacy_params = h["final_params"]
        elif sched["mode"] == "sync":
            same = all(torch.equal(legacy_params[k], h["final_params"][k])
                       for k in legacy_params)
            if not same:
                raise AssertionError(f"runtime {name}: params differ from the "
                                     "legacy run's on the card")
        applied = h["apply_s"] > 0
        row = dict(
            host_wall_s=wall, host_s_per_round=wall / cfg.rounds,
            host_rounds_per_s=cfg.rounds / wall,
            median_apply_ms=float(np.median(h["apply_s"][applied]) * 1e3),
            launches=got, loss_first=float(loss[0]), loss_last=float(loss[-1]))
        if sched is not None:
            s = h["scheduler"]
            if csv_mode is not None:
                _check_modeled(name, s, h, csv_rows[csv_mode])
            row.update(
                modeled_makespan_s=s["makespan_s"],
                modeled_rounds_per_s=s["rounds_per_s"],
                modeled_clients_per_s=s["clients_per_s"],
                modeled_params_lag_max=s["params_lag_max"],
                stale_admitted=s["stale_admitted"],
                stale_dropped=s["stale_dropped"],
                queue_peak_bytes=s["queue_peak_bytes"],
                agg_state_bytes_peak=s["agg_state_bytes_peak"],
                client_state_bytes=s["client_state_bytes"],
                matches_csv=csv_mode)
            if sched["mode"] == "sync":
                row["params_bitwise_legacy"] = True
        rows[name] = row
        print(f"runtime: {name}: " + json.dumps(row), flush=True)

    # The async runs, 3 rounds on the card against the CPU, both on the
    # decode route (threshold pinned at 512).  The card run must have gone
    # through the kernels; the CPU run launches none.
    for name in ("sched_async", "qsgd_sched_async"):
        over, sched, expect, _ = SCHED_RUNS[name]
        cfg = _sched_config(dict(over, kernel_cohort_threshold=512), sched,
                            rounds=SCHED_PARITY_ROUNDS)
        hs = {}
        for dev in ("cuda", "cpu"):
            fns.reset()
            hs[dev] = run_federation(cfg, init_mlp(seed=2, device=dev), clients,
                                     xte, yte, device=dev)
            if dev == "cuda":
                got = _sched_launches(name, cfg, hs[dev], fns, expect)
            elif any(fns.read().values()):
                raise AssertionError(f"runtime {name}: the CPU run launched "
                                     "a kernel")
        for key in stat_keys:
            if not np.array_equal(hs["cuda"][key], hs["cpu"][key]):
                raise AssertionError(f"runtime {name}: card vs CPU: {key} differs")
        for key in SCHEDULE_KEYS:
            a, b = hs["cuda"]["scheduler"][key], hs["cpu"]["scheduler"][key]
            if a.tobytes() != b.tobytes():
                raise AssertionError(f"runtime {name}: card vs CPU: {key} differs")
        err = max(float((hs["cuda"]["final_params"][k].cpu()
                         - hs["cpu"]["final_params"][k]).abs().max())
                  for k in hs["cpu"]["final_params"])
        tol = 2e-6 if over.get("protocol_name") == "qsgd" else 1e-6
        if not err <= tol:
            raise AssertionError(f"runtime {name}: card differs from CPU by "
                                 f"{err} after {cfg.rounds} rounds (tolerance {tol})")
        print(f"runtime: {name}: {cfg.rounds} rounds, card vs CPU: stats and "
              f"schedule bitwise, max |dparams| {err!r} (tolerance {tol}), "
              f"card launches {got}", flush=True)

    # tests/test_scheduler.py's state audit at 10⁶ registered clients.
    cfg = _sched_config(
        dict(population=10**6, participation=2e-5,
             channel=ChannelConfig(base_latency_s=0.05, lognormal_sigma=0.5)),
        dict(mode="async", period_s=0.004, max_rounds_in_flight=4,
             quorum_frac=0.5, staleness_window=2, audit_queues=True), rounds=2)
    fns.reset()
    t0 = time.perf_counter()
    h = run_federation(cfg, init_mlp(seed=0, device="cuda"), clients, xte, yte,
                       device="cuda")
    wall = time.perf_counter() - t0
    # cohorts of 20 stay under the 512-upload decode threshold: the encode
    # kernel runs, the close is the plain per-client loop (the reference's
    # routing)
    got = _sched_launches("audit_1e6", cfg, h, fns, ("encode",))
    s = h["scheduler"]
    audit = dict(launches=got,client_state_bytes=s["client_state_bytes"],
                 queue_entry_bytes=s["queue_entry_bytes"],
                 queue_peak_bytes=s["queue_peak_bytes"],
                 agg_state_bytes_peak=s["agg_state_bytes_peak"],
                 modeled_params_lag_max=s["params_lag_max"], host_wall_s=wall)
    if not (s["client_state_bytes"] == 4 * 10**6
            and s["queue_entry_bytes"] == 32
            and s["queue_peak_bytes"] <= 20 * 4 * 32
            and s["agg_state_bytes_peak"] <= 20 * 4 * (4 + 24) + 96 * 8
            and s["params_lag_max"] <= 4):
        raise AssertionError(f"runtime audit_1e6: state bound broken: {audit}")
    rows["audit_1e6"] = audit
    print("runtime: audit_1e6: " + json.dumps(audit), flush=True)
    return rows


def phase_main_path(s: Smoke):
    """run_simulation on the card; the kernels must carry it."""
    import numpy as np
    import torch

    from repro_torch.core import fedscalar as fs
    from repro_torch.data import load_digits, make_client_datasets
    from repro_torch.data import train_test_split_arrays
    from repro_torch.fed.simulation import (
        SimulationConfig,
        protocol_config,
        run_simulation,
    )
    from repro_torch.models.mlp_classifier import init_mlp, mlp_grad

    x, y = load_digits()
    xtr, ytr, xte, yte = train_test_split_arrays(x, y)
    clients = make_client_datasets(xtr, ytr, 20)
    fns = Launches({k: c for k, c in _kernel_fns().items() if k != "rec"})
    launches = dict.fromkeys(fns, 0)
    for method in MAIN_METHODS:
        cfg = SimulationConfig(method=method, rounds=MAIN_ROUNDS, num_clients=20,
                               local_steps=5, batch_size=32, seed=0)
        params = init_mlp(seed=0, device="cuda")
        fns.reset()
        h = run_simulation(cfg, params, clients, xte, yte, device="cuda")
        got = fns.read()
        for k in launches:
            launches[k] += got[k]
        expect = MAIN_KERNELS.get(method, ("encode", "fused"))
        loss = h["loss"]
        if any(got[k] == 0 for k in expect) or any(
                got[k] for k in got if k not in expect):
            raise AssertionError(f"{method}: launches {got}, expected only {expect}")
        if not np.isfinite(loss).all() or not loss[-1] < loss[0]:
            raise AssertionError(f"{method}: loss did not fall: {loss[0]} -> {loss[-1]}")
        if not all(p.is_cuda for p in h["final_params"].values()):
            raise AssertionError(f"{method}: params left the card")
        steady = (MAIN_ROUNDS - 1) / h["sim_compute_seconds"]
        total_s = h["sim_compile_seconds"] + h["sim_compute_seconds"]
        print(f"main: {method}: {MAIN_ROUNDS} rounds, loss {float(loss[0])!r} -> "
              f"{float(loss[-1])!r}, final accuracy {float(h['accuracy'][-1])!r}, "
              f"{MAIN_ROUNDS / total_s!r} rounds/s overall, {steady!r} rounds/s "
              f"after round 1 (first round {h['sim_compile_seconds']!r} s), "
              f"launches {json.dumps(got)}", flush=True)

    # One round on the card against the same round on the CPU (plain path),
    # for the fedscalar methods; qsgd's card-vs-CPU round is phase 5's.
    g = torch.Generator().manual_seed(1)
    bx = (torch.rand((20, 5, 32, 64), generator=g) * 16).float()
    by = torch.randint(0, 10, (20, 5, 32), generator=g)
    for method in MAIN_METHODS:
        if method in MAIN_KERNELS:
            continue
        pc = protocol_config(SimulationConfig(method=method))
        p0 = init_mlp(seed=2, device="cpu")
        ef = None
        if pc.error_feedback:
            ef = {k: 1e-3 * torch.randn((20,) + tuple(v.shape), generator=g)
                  for k, v in p0.items()}
        cpu, (_, ef_c) = fs.fedscalar_round(p0, (bx, by), 3, mlp_grad, pc, ef)
        gpu, (_, ef_g) = fs.fedscalar_round(
            {k: v.cuda() for k, v in p0.items()}, (bx.cuda(), by.cuda()), 3,
            mlp_grad, pc, None if ef is None else {k: v.cuda() for k, v in ef.items()})
        err = max(float((gpu[k].cpu() - cpu[k]).abs().max()) for k in cpu)
        if ef is not None:
            err = max([err] + [float((ef_g[k].cpu() - ef_c[k]).abs().max())
                               for k in ef_c])
        if not err <= 1e-6:
            raise AssertionError(f"{method}: card round differs from CPU by {err}")
        print(f"main: {method}: one round, card vs CPU max |dparams|"
              f"{', |def|' if ef is not None else ''} {err!r}")
    return launches


def phase_times(s: Smoke):
    """CUDA-event times of each kernel, its plain version, and its bound."""
    import torch

    from repro_torch.core.prng import Distribution
    from repro_torch.core.projection import ProjectionMode
    from repro_torch.kernels import ops
    from repro_torch.kernels.reconstruct_apply import (
        fused_apply_plain,
        fused_reconstruct_apply,
        fused_tree_plain,
        pad_cohort,
    )
    from repro_torch.kernels.seeded_projection import (
        project_blocks,
        project_blocks_plain,
        project_tree_plain,
    )
    from repro_torch.kernels.tree import tree_plan

    # The main path's round: the 6 MLP leaves, N = 20, k = 1, one tree
    # launch each for the encode (plus its reduction) and the fused close,
    # through the entry points run_simulation calls.
    mlp = [(1, 24), (1, 12), (1, 10), (64, 24), (24, 12), (12, 10)]
    n, k = 20, 1
    one = torch.ones(1, device=s.dev)
    zero = torch.zeros(1, device=s.dev)
    deltas = {f"l{tag}": s.randn(n, r, c) for tag, (r, c) in enumerate(mlp)}
    params = {f"l{tag}": s.randn(r, c) for tag, (r, c) in enumerate(mlp)}
    seeds = s.seeds(n)
    rs = s.randn(n, k)
    d_leaves = [deltas[key] for key in sorted(deltas)]
    p_leaves = [params[key] for key in sorted(params)]
    f32 = [torch.float32] * len(mlp)
    enc_plan = tree_plan("encode", mlp, f32, k, ProjectionMode.FULL, s.dev)
    fus_plan = tree_plan("close", mlp, f32, k, ProjectionMode.FULL, s.dev)
    rd = Distribution.RADEMACHER

    def enc_kernel():
        ops.project_tree_kernel(deltas, seeds, rd)

    def enc_plain():
        project_tree_plain(d_leaves, seeds, enc_plan)

    def fus_kernel():
        ops.server_update_fused(params, rs, seeds, 1.0, rd)

    def fus_plain():
        fused_tree_plain(p_leaves, seeds, rs, 1.0 / n, fus_plan)

    e0, f0 = _totals()["encode.launches"], _totals()["close.launches"]
    enc_kernel()
    fus_kernel()
    per_round = {"encode": _totals()["encode.launches"] - e0,
                 "fused": _totals()["close.launches"] - f0}
    # plain, kernel, kernel, plain: two turns each, on one card.
    t = {}
    for name, fn in (("enc_plain", enc_plain), ("enc_kernel", enc_kernel),
                     ("enc_kernel2", enc_kernel), ("enc_plain2", enc_plain),
                     ("fus_plain", fus_plain), ("fus_kernel", fus_kernel),
                     ("fus_kernel2", fus_kernel), ("fus_plain2", fus_plain)):
        t[name] = s.time_ms(fn, reps=50)
    # The same calls with the host kept out (the device's own time), and
    # the host's enqueue time of one call.
    t["enc_device"] = _device_ms([enc_kernel], reps=20)
    t["fus_device"] = _device_ms([fus_kernel], reps=20)
    t["enc_enqueue"] = _enqueue_ms(enc_kernel)
    t["fus_enqueue"] = _enqueue_ms(fus_kernel)
    enc_b, enc_by = _encode_bound(mlp, n, k)
    fus_b, fus_by = _fused_bound(mlp, n, k)
    print("times (main path, one round: 6 MLP leaves, N=20, k=1, rademacher; "
          f"launches per round {json.dumps(per_round)}): " + json.dumps(t),
          flush=True)

    rows = []
    r, c = LARGE
    x = s.randn(16, r, c)
    lo, hi = zero, one * (r * c)
    sd = s.seeds(16)
    ke = s.time_ms(lambda: project_blocks(x, sd, 9, lo, hi), reps=5, warmup=1)
    pe = s.time_ms(lambda: project_blocks_plain(x, sd, 9, lo, hi), reps=1,
                   warmup=0)
    b, by = _encode_bound([LARGE], 16, 1)
    rows.append(dict(kernel="encode", shape=list(LARGE), cohort=16, k=1,
                     ms=ke, plain_ms=pe, bound_ms=b, bound_by=by))
    x2d = x[0].contiguous()
    del x
    torch.cuda.empty_cache()
    for cohort in (256, 1024):
        sd = s.seeds(cohort)
        rsl = s.randn(cohort, 1) * (1.0 / cohort)
        spl, rpl = pad_cohort(sd, rsl)
        kf = s.time_ms(lambda: fused_reconstruct_apply(x2d, sd, rsl, 9, 1.0,
                                                       lo=lo, hi=hi),
                       reps=3, warmup=1)
        pf = s.time_ms(lambda: fused_apply_plain(x2d, spl, rpl, 9, lo, hi),
                       reps=1, warmup=0)
        b, by = _fused_bound([LARGE], cohort, 1)
        rows.append(dict(kernel="fused", shape=list(LARGE), cohort=cohort, k=1,
                         ms=kf, plain_ms=pf, bound_ms=b, bound_by=by))
    print("times (large leaf, rademacher): " + json.dumps({"rows": rows}),
          flush=True)
    if per_round != {"encode": 2, "fused": 1}:
        raise AssertionError(f"times: a round took {per_round} launches, "
                             "expected one tree launch each (and the reduction)")
    return {
        "encode": dict(ms=(t["enc_kernel"] + t["enc_kernel2"]) / 2,
                       plain_ms=(t["enc_plain"] + t["enc_plain2"]) / 2,
                       bound_ms=enc_b, bound_by=enc_by),
        "fused": dict(ms=(t["fus_kernel"] + t["fus_kernel2"]) / 2,
                      plain_ms=(t["fus_plain"] + t["fus_plain2"]) / 2,
                      bound_ms=fus_b, bound_by=fus_by),
    }


def phase_times_runtime(s: Smoke):
    """CUDA-event times of the per-client decode and QSGD kernels."""
    import torch

    from repro_torch.core import qsgd as tq
    from repro_torch.core.prng import Distribution
    from repro_torch.core.projection import ProjectionMode
    from repro_torch.fed.protocols import make_protocol
    from repro_torch.kernels import ops
    from repro_torch.kernels.qsgd_quant import (
        qsgd_quantize,
        qsgd_quantize_plain,
        qsgd_tree,
        qsgd_tree_plain,
    )
    from repro_torch.kernels.reconstruct_apply import fused_reconstruct_apply
    from repro_torch.kernels.seeded_reconstruct import (
        reconstruct_apply_clients,
        reconstruct_plain,
        reconstruct_tree_plain,
    )
    from repro_torch.kernels.tree import tree_plan
    from repro_torch.models.mlp_classifier import init_mlp

    one = torch.ones(1, device=s.dev)
    zero = torch.zeros(1, device=s.dev)
    # Main path: one round's apply at cohort 1000 (the bucket pads to 1024)
    # over the 6 MLP leaves through the tree entry the runtime calls (one
    # decode launch), and one round's qsgd encode (levels and norms) through
    # QSGDProtocol.encode_cohort, chunk by chunk as the runtime calls it
    # (client_chunk 256: 256, 256, 256, 232 clients).
    n = 1024
    seeds = s.seeds(n)
    rs = s.randn(n, 1)
    params = {f"l{tag}": s.randn(r, c) for tag, (r, c) in enumerate(MLP)}
    p_leaves = [params[key] for key in sorted(params)]
    plan = tree_plan("decode", MLP, [torch.float32] * len(MLP), 1,
                     ProjectionMode.FULL, s.dev)
    mlp = init_mlp(seed=0, device=s.dev)
    proto = make_protocol("qsgd", mlp)
    chunks = []
    for lo in range(0, 1000, 256):
        m = min(256, 1000 - lo)
        chunks.append(({k: s.randn(m, *v.shape) * 0.01 for k, v in mlp.items()},
                       torch.arange(lo, lo + m, device=s.dev)))
    rd = Distribution.RADEMACHER

    def rec_kernel():
        ops.server_update_kernel(params, rs, seeds, 1.0, rd)

    def rec_plain():
        reconstruct_tree_plain(p_leaves, seeds, rs, 1.0 / n, 1.0, plan)

    def q_kernel():
        for deltas, ids in chunks:
            proto.encode_cohort(deltas, None, 3, ids)

    def q_plain():
        for deltas, ids in chunks:
            qsgd_tree_plain([deltas[k] for k in sorted(deltas)],
                            tq.quant_seeds(3, ids, s.dev), 127, want_q=False,
                            want_levels=True)

    r0 = _totals()["decode.launches"]
    rec_kernel()
    rec_launches = _totals()["decode.launches"] - r0
    q0 = _totals()["qsgd.launches"]
    q_kernel()
    q_launches = _totals()["qsgd.launches"] - q0
    t = {}
    for name, fn, reps in (("rec_plain", rec_plain, 3), ("rec_kernel", rec_kernel, 50),
                           ("rec_kernel2", rec_kernel, 50), ("rec_plain2", rec_plain, 3),
                           ("qsgd_plain", q_plain, 10), ("qsgd_kernel", q_kernel, 50),
                           ("qsgd_kernel2", q_kernel, 50), ("qsgd_plain2", q_plain, 10)):
        t[name] = s.time_ms(fn, reps=reps, warmup=1)
    # The same calls with the host kept out (the device's own time), and the
    # host's enqueue time of one call (a round's four encode calls for qsgd).
    t["rec_device"] = _device_ms([rec_kernel], reps=20)
    t["rec_enqueue"] = _enqueue_ms(rec_kernel)
    t["qsgd_device"] = _device_ms([q_kernel], reps=20)
    t["qsgd_enqueue"] = _enqueue_ms(q_kernel)
    rec_b, rec_by = _rec_bound(MLP, n, 1)
    q_b, q_by = _qsgd_bound(MLP, 1000, 1)
    print("times (runtime main path, one round: 6 MLP leaves; decode N=1024, "
          f"k=1, {rec_launches} launch, V=1: {not plan.groups[0].vector}; qsgd "
          f"encode_cohort over 4 chunks (N=1000), levels and norms, bits=8, "
          f"{q_launches} launches): " + json.dumps(t), flush=True)
    if rec_launches != 1:
        raise AssertionError(f"times: the round's decode took {rec_launches} "
                             "launches, expected one tree launch")
    if q_launches != 2 * len(chunks):
        raise AssertionError(f"times: the round's qsgd encode took {q_launches} "
                             f"launches, expected 2 for each of {len(chunks)} chunks")
    del chunks

    rows = []
    r, c = LARGE
    x2d = s.randn(r, c)
    for cohort in (256, 1024):
        sd = s.seeds(cohort)
        rsl = s.randn(cohort, 1) * (1.0 / cohort)
        tt = {}
        for name, fn in (
                ("fused", lambda: fused_reconstruct_apply(x2d, sd, rsl, 9, 1.0,
                                                          lo=zero, hi=one * (r * c))),
                ("rec", lambda: reconstruct_apply_clients(x2d, sd, rsl, 9, 1.0,
                                                          lo=zero, hi=one * (r * c))),
                ("rec2", lambda: reconstruct_apply_clients(x2d, sd, rsl, 9, 1.0,
                                                           lo=zero, hi=one * (r * c))),
                ("fused2", lambda: fused_reconstruct_apply(x2d, sd, rsl, 9, 1.0,
                                                           lo=zero, hi=one * (r * c)))):
            tt[name] = s.time_ms(fn, reps=3, warmup=1)
        pr = s.time_ms(lambda: reconstruct_plain(x2d, sd, rsl, 9, 1.0, zero,
                                                 one * (r * c)), reps=1, warmup=0)
        b, by = _rec_bound([LARGE], cohort, 1)
        rows.append(dict(kernel="rec", shape=list(LARGE), cohort=cohort, k=1,
                         ms=(tt["rec"] + tt["rec2"]) / 2,
                         fused_ms=(tt["fused"] + tt["fused2"]) / 2,
                         plain_ms=pr, bound_ms=b, bound_by=by))
    del x2d
    torch.cuda.empty_cache()
    # The large leaf through the tree entry (norm pass in the kernel, q and
    # the levels into a (16, d + 1) payload, whose rows are not 16-byte
    # aligned), the same with the norms given (the quantize pass alone, so
    # the difference is the norm pass), and the kernel given the norms on a
    # one-leaf table (qsgd_quantize: the levels as (16, rows, cols), aligned).
    x = s.randn(16, r, c) * 0.01
    sd = s.seeds(16)
    nm = qsgd_tree([x], sd, 127, want_q=True)[2][:, 0].contiguous()

    def tree_call(norms=None):
        return lambda: qsgd_tree([x], sd, 127, want_q=True, want_levels=True,
                                 norms=norms)

    tt = {}
    for name, fn in (("tree", tree_call()), ("tree_given", tree_call(nm)),
                     ("given", lambda: qsgd_quantize(x, sd, nm, 127, True, True)),
                     ("given2", lambda: qsgd_quantize(x, sd, nm, 127, True, True)),
                     ("tree_given2", tree_call(nm)), ("tree2", tree_call())):
        tt[name] = s.time_ms(fn, reps=5, warmup=1)
    pq = s.time_ms(lambda: qsgd_quantize_plain(x, sd, nm, 127, True, True),
                   reps=1, warmup=0)
    b, by = _qsgd_bound([LARGE], 16, 2)
    tree_ms = (tt["tree"] + tt["tree2"]) / 2
    quant_ms = (tt["tree_given"] + tt["tree_given2"]) / 2
    rows.append(dict(kernel="qsgd", shape=list(LARGE), cohort=16, bits=8,
                     outputs="q and levels", ms=tree_ms, quantize_pass_ms=quant_ms,
                     norm_pass_ms=tree_ms - quant_ms,
                     one_leaf_given_norms_ms=(tt["given"] + tt["given2"]) / 2,
                     turns=tt, plain_ms=pq, bound_ms=b, bound_by=by))
    del x
    torch.cuda.empty_cache()
    print("times (runtime slice, large leaf, rademacher): "
          + json.dumps({"rows": rows}), flush=True)
    return {
        "rec": dict(ms=(t["rec_kernel"] + t["rec_kernel2"]) / 2,
                    plain_ms=(t["rec_plain"] + t["rec_plain2"]) / 2,
                    bound_ms=rec_b, bound_by=rec_by),
        "qsgd": dict(ms=(t["qsgd_kernel"] + t["qsgd_kernel2"]) / 2,
                     plain_ms=(t["qsgd_plain"] + t["qsgd_plain2"]) / 2,
                     bound_ms=q_b, bound_by=q_by),
    }


def phase_flash(s: Smoke):
    """Flash attention against its plain version, on the card."""
    import torch

    t0 = time.perf_counter()
    n0 = s.checks
    s.group = ("flash attention, ragged S = T (333, 1000; 333 with kpos -1 "
               "holes and 40 padding queries): hd 32/64/128, MHA/GQA3/MQA, "
               "causal and window 64")
    for dtype in (torch.float32, torch.bfloat16):
        for hd in (32, 64, 128):
            for h, kh in ((4, 4), (6, 2), (4, 1)):
                for window in (0, 64):
                    s.check_flash(2, 333, 333, h, kh, hd, dtype, window)
                    s.check_flash(1, 1000, 1000, h, kh, hd, dtype, window)
                    kpos = torch.arange(333)
                    kpos[::5] = -1
                    qpos = torch.arange(333)
                    qpos[:40] = -1
                    s.check_flash(1, 333, 333, h, kh, hd, dtype, window, qpos,
                                  kpos)
    s.report()
    s.group = ("flash attention, decode S = 1 against T = 16424 (SmolLM heads), "
               "and a wrapped ring of 1000 (unsorted kpos; S = 1 and 300; "
               "window 0, 64, 1000)")
    filled = SERVE_PROMPT + SERVE_GEN // 2
    dec_kpos = torch.where(torch.arange(SERVE_CAPACITY) < filled,
                           torch.arange(SERVE_CAPACITY), -1)
    ring = torch.full((1000,), -1, dtype=torch.int64)
    written = torch.arange(500, 1500)
    ring[written % 1000] = written
    for dtype in (torch.float32, torch.bfloat16):
        s.check_flash(SERVE_BATCH, 1, SERVE_CAPACITY, 15, 5, 64, dtype,
                      qpos=torch.tensor([filled - 1]), kpos=dec_kpos)
        for window in (0, 64, 1000):
            s.check_flash(2, 1, 1000, 6, 2, 64, dtype, window,
                          torch.tensor([1499]), ring)
            s.check_flash(2, 300, 1000, 6, 2, 64, dtype, window,
                          torch.arange(1200, 1500), ring)
    s.report()
    s.group = (f"flash attention, SmolLM-360M prefill shape (B={SERVE_BATCH}, "
               f"S=T={SERVE_PROMPT}, 15/5 heads, hd 64)")
    for dtype in (torch.bfloat16, torch.float32):
        s.check_flash(SERVE_BATCH, SERVE_PROMPT, SERVE_PROMPT, 15, 5, 64, dtype)
        torch.cuda.empty_cache()
    s.report()
    torch.cuda.empty_cache()
    worst, counts = {}, dict.fromkeys(FLASH_KERNELS.values(), 0)
    for (_, kernel, family), st in s.stats.items():
        if kernel in counts:
            counts[kernel] += st[0]
            w = worst.setdefault(f"{kernel} {family.split()[0]}", [0.0, 0.0])
            w[0], w[1] = max(w[0], st[3]), max(w[1], st[4])
    if not all(counts.values()):
        raise AssertionError(f"flash checks per kernel {counts}: a kernel was "
                             "never checked")
    print(f"flash: all {s.checks - n0} checks ok in {time.perf_counter() - t0:.1f} s "
          f"(per kernel {json.dumps(counts)}); max |err| "
          f"{json.dumps({k: s.errs[k] for k in counts})}; max err over its limit "
          f"and max share changed: {json.dumps(worst)}", flush=True)


def _flash_bound(route, b, s_len, t, h, kh, hd, elem, pairs):
    """Least time: the allowed pairs' arithmetic, or q, k, v, out and the
    positions once over HBM.  bf16 routes: 4·hd flops per pair at the bf16
    tensor rate; the float32 kernel (CUDA cores, no TF32): 2·hd FMAs per
    pair (q·k and p·v) at the float32 FMA issue rate."""
    nbytes = elem * (2 * b * s_len * h * hd + 2 * b * t * kh * hd) + 4 * (s_len + t)
    if route == "f32":
        t_ops = 2 * hd * pairs / FP32_OPS_PER_S * 1e3
    else:
        t_ops = 4 * hd * pairs / BF16_FLOPS_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _flash_time_row(s: Smoke, route, b, s_len, t, h, kh, hd, dtype, qpos, kpos):
    """CUDA-event times of the kernel ``route`` names on random q, k, v of
    this shape, in turns with SDPA (kernel, SDPA, kernel), beside its plain
    version and its bound.  → the row."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    import repro_torch.kernels.flash_attention as fa

    fused = [SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
             SDPBackend.CUDNN_ATTENTION]
    if fa.flash_route(s_len, h, kh, dtype) != route:
        raise AssertionError(f"flash times: the {route} shape routes elsewhere")
    kernel = _flash_counters()[route]
    q = s.randn(b, s_len, h, hd).to(dtype)
    k = s.randn(b, t, kh, hd).to(dtype)
    v = s.randn(b, t, kh, hd).to(dtype)
    reps = 50 if route == "decode" else 3
    # The yardstick: one PyTorch call on the same inputs in its own
    # layout (transposed outside the timed region), held to its fused
    # backends so that it never materialises the (S, T) scores.  Never
    # used by the port.
    # float32 has no fused backend with GQA: its K/V heads are
    # repeated to H outside the timed region.
    gqa = dtype == torch.bfloat16
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    if not gqa:
        kt, vt = (x.repeat_interleave(h // kh, dim=1) for x in (kt, vt))
    kw = (dict(attn_mask=(kpos >= 0)[None, None, None, :]) if route == "decode"
          else dict(is_causal=True))

    def lib():
        with sdpa_kernel(fused):
            return F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=gqa, **kw)

    def kern():
        return fa.flash_attention(q, k, v, qpos, kpos)

    tt = {"plain": s.time_ms(lambda: fa.flash_attention_plain(q, k, v, qpos, kpos),
                             reps=1, warmup=1)}
    before = _totals()[kernel]
    tt["kernel"] = s.time_ms(kern, reps=reps, warmup=1)
    tt["library"] = s.time_ms(lib, reps=reps, warmup=1)
    tt["kernel2"] = s.time_ms(kern, reps=reps, warmup=1)
    if _totals()[kernel] - before != 2 * (reps + 1):
        raise AssertionError(f"flash times: {route} timed another kernel")
    ref = lib().transpose(1, 2).float()
    lib_err = float((ref - kern().float()).abs().max())
    pairs = int(fa.allowed_mask(qpos, kpos, True, 0).sum()) * b * h
    bound, by = _flash_bound(route, b, s_len, t, h, kh, hd, dtype.itemsize, pairs)
    ms = (tt["kernel"] + tt["kernel2"]) / 2
    row = dict(kernel=FLASH_KERNELS[route],
               shape=dict(B=b, S=s_len, T=t, H=h, K=kh, hd=hd,
                          dtype=str(dtype).removeprefix("torch.")),
               allowed_pairs=pairs, ms=ms, kernel_turns_ms=[tt["kernel"], tt["kernel2"]],
               plain_ms=tt["plain"], library_ms=tt["library"],
               library_max_abs_diff=lib_err, bound_ms=bound, bound_by=by,
               tflops=4 * hd * pairs / (ms * 1e-3) / 1e12,
               gbytes_per_s=(dtype.itemsize * (2 * b * s_len * h * hd + 2 * b * t * kh * hd)
                             / (ms * 1e-3) / 1e9))
    del q, k, v, qt, kt, vt, ref
    torch.cuda.empty_cache()
    return row


def phase_flash_times(s: Smoke):
    """CUDA-event times of the three flash kernels, each at the shape the
    main paths give it, in turns with SDPA."""
    import torch

    rows = {}
    h, kh, hd = 15, 5, 64
    filled = SERVE_PROMPT + SERVE_GEN // 2
    i32 = dict(dtype=torch.int32, device=s.dev)
    shapes = {   # route -> (batch, S, T, dtype, qpos, kpos)
        "prefill": (SERVE_BATCH, SERVE_PROMPT, SERVE_PROMPT, torch.bfloat16,
                    torch.arange(SERVE_PROMPT, **i32), torch.arange(SERVE_PROMPT, **i32)),
        "decode": (SERVE_BATCH, 1, SERVE_CAPACITY, torch.bfloat16,
                   torch.tensor([filled - 1], **i32),
                   torch.where(torch.arange(SERVE_CAPACITY, **i32) < filled,
                               torch.arange(SERVE_CAPACITY, **i32), -1)),
        "f32": (1, PARITY_PROMPT, PARITY_PROMPT, torch.float32,
                torch.arange(PARITY_PROMPT, **i32), torch.arange(PARITY_PROMPT, **i32)),
    }
    for route, (b, s_len, t, dtype, qpos, kpos) in shapes.items():
        rows[route] = _flash_time_row(s, route, b, s_len, t, h, kh, hd, dtype, qpos, kpos)
        print(f"flash times ({route}): " + json.dumps(rows[route]), flush=True)
    return rows


def _flash_counters():
    return Launches({"all": "flash.launches", "prefill": "flash_prefill.launches",
                     "decode": "flash_decode.launches", "f32": "flash_f32.launches"})


# Minitron-8B's attention at its training sequence (fedbench's
# minitron-8b-base.fedround): (B, S, H, K, hd), causal
FLASH_TRAIN_SHAPE = (1, 4096, 48, 8, 128)


def phase_flash_train(s: Smoke):
    """The float32 training kernels at FLASH_TRAIN_SHAPE, CUDA events: the
    forward with its lse output and the backward, each in turns (kernel,
    plain, kernel), beside its bound and its plain version.  The bound is
    the FMAs the function needs an allowed pair at the float32 FMA rate:
    2·hd forward (QKᵀ, P·V), 5·hd backward (S = QKᵀ, dP = dO·Vᵀ, dV, dK,
    dQ); the backward kernels' recompute of S and dP for dQ, 2·hd more, is
    the design's and not counted; then a whole
    FlashAttentionF32 forward and backward beside the plain ``_sdpa``'s under
    autograd (the route it replaces) and, as a yardstick only,
    ``scaled_dot_product_attention``'s float32 forward and backward (K/V
    repeated to H outside the timed region).  Checks the gradients within
    1e-4 of the plain backward's largest and two backward runs bitwise.
    → the row."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    import repro_torch.kernels.flash_attention as fa
    from repro_torch.models import attention

    b, sl, h, kh, hd = FLASH_TRAIN_SHAPE
    q, dy = s.randn(b, sl, h, hd), s.randn(b, sl, h, hd)
    k, v = s.randn(b, sl, kh, hd), s.randn(b, sl, kh, hd)
    pos = torch.arange(sl, dtype=torch.int32, device=s.dev)
    pairs = int(fa.allowed_mask(pos, pos, True, 0).sum()) * b * h
    out, lse = fa.flash_attention_fwd_lse(q, k, v, pos, pos)
    grads = fa.flash_attention_bwd(q, k, v, out, dy, lse, pos, pos)
    again = fa.flash_attention_bwd(q, k, v, out, dy, lse, pos, pos)
    plain = fa.flash_attention_bwd_plain(q, k, v, out, dy, lse, pos, pos)
    if not all(torch.equal(a, g) for a, g in zip(grads, again)):
        raise AssertionError("flash train: two backward runs differ")
    errs = [float((a - p).abs().max()) / float(p.abs().max()) for a, p in zip(grads, plain)]
    if max(errs) > 1e-4:
        raise AssertionError(f"flash train: gradients {errs} of the plain backward's largest")
    del plain, again

    def fwd():
        return fa.flash_attention_fwd_lse(q, k, v, pos, pos)

    def bwd():
        return fa.flash_attention_bwd(q, k, v, out, dy, lse, pos, pos)

    def both(fn):
        leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
        return torch.autograd.grad(fn(*leaves), leaves, dy)

    def flash_both():
        return both(lambda *a: fa.flash_attention_train(*a, pos, pos))

    def sdpa_plain(*a):
        route = attention._flash_train_route
        attention._flash_train_route = lambda *_: False
        try:
            return attention._sdpa(*a, pos, pos, causal=True, window=0, prefix_len=0)
        finally:
            attention._flash_train_route = route

    qt, dyt = q.transpose(1, 2).contiguous(), dy.transpose(1, 2).contiguous()
    kt, vt = (x.transpose(1, 2).repeat_interleave(h // kh, dim=1).contiguous()
              for x in (k, v))

    def library():
        leaves = [x.detach().requires_grad_(True) for x in (qt, kt, vt)]
        with sdpa_kernel([SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                          SDPBackend.CUDNN_ATTENTION]):
            o = F.scaled_dot_product_attention(*leaves, is_causal=True)
        return torch.autograd.grad(o, leaves, dyt)

    tt = {}
    for name, fn, reps in (("fwd", fwd, 5), ("fwd_plain", lambda: fa.flash_attention_fwd_lse_plain(
            q, k, v, pos, pos), 1), ("fwd2", fwd, 5), ("bwd", bwd, 3),
            ("bwd_plain", lambda: fa.flash_attention_bwd_plain(q, k, v, out, dy, lse, pos, pos), 1),
            ("bwd2", bwd, 3), ("train", flash_both, 3),
            ("sdpa_plain", lambda: both(sdpa_plain), 1), ("library", library, 3),
            ("train2", flash_both, 3)):
        tt[name] = s.time_ms(fn, reps=reps, warmup=1)
        torch.cuda.empty_cache()
    fwd_ms, bwd_ms = (tt["fwd"] + tt["fwd2"]) / 2, (tt["bwd"] + tt["bwd2"]) / 2
    fwd_bound = 2 * hd * pairs / FP32_OPS_PER_S * 1e3
    bwd_bound = 5 * hd * pairs / FP32_OPS_PER_S * 1e3
    row = dict(shape=dict(B=b, S=sl, T=sl, H=h, K=kh, hd=hd, dtype="float32", causal=True),
               allowed_pairs=pairs,
               fwd_lse=dict(ms=fwd_ms, turns_ms=[tt["fwd"], tt["fwd2"]],
                            plain_ms=tt["fwd_plain"], bound_ms=fwd_bound,
                            bound_pct=100 * fwd_bound / fwd_ms),
               bwd=dict(ms=bwd_ms, turns_ms=[tt["bwd"], tt["bwd2"]],
                        plain_ms=tt["bwd_plain"], bound_ms=bwd_bound,
                        bound_pct=100 * bwd_bound / bwd_ms,
                        design_fma_per_pair=7 * hd, bound_fma_per_pair=5 * hd,
                        max_grad_err_over_plain_max=max(errs)),
               fwd_bwd=dict(ms=(tt["train"] + tt["train2"]) / 2,
                            turns_ms=[tt["train"], tt["train2"]],
                            sdpa_plain_ms=tt["sdpa_plain"], library_ms=tt["library"]))
    print("flash train times: " + json.dumps(row), flush=True)
    del q, k, v, dy, out, lse, grads, qt, kt, vt, dyt
    torch.cuda.empty_cache()
    return row


def _positions(cfg, batch):
    """Decoder positions a prefill of ``batch`` fills: the VLM's patch
    embeddings come before its text, the enc-dec's frames go to the encoder."""
    n = batch["tokens"].shape[1]
    return n + batch["embeds"].shape[1] if cfg.frontend == "vision" else n


def _frontend(cfg, batch, positions, gen=None, device=None):
    """``{"tokens"[, "embeds"]}`` filling ``positions`` decoder positions:
    tokens and the stubbed frontend's embeddings (0.02·N(0, 1), as the
    reference's examples/serve_llm.py) from numpy with seed 0, or from
    ``gen`` on ``device``."""
    import numpy as np
    import torch

    n_emb = {"vision": cfg.num_frontend_tokens, "audio": cfg.encoder_seq}.get(
        cfg.frontend, 0)
    n_tok = positions - (n_emb if cfg.frontend == "vision" else 0)
    if gen is None:
        rng = np.random.RandomState(0)
        out = {"tokens": torch.from_numpy(rng.randint(0, cfg.vocab_size, (batch, n_tok)))}
        if n_emb:
            out["embeds"] = torch.from_numpy(
                (rng.randn(batch, n_emb, cfg.d_model) * 0.02).astype(np.float32))
        return out
    out = {"tokens": torch.randint(0, cfg.vocab_size, (batch, n_tok), generator=gen,
                                   device=device)}
    if n_emb:
        out["embeds"] = (torch.randn(batch, n_emb, cfg.d_model, generator=gen,
                                     device=device) * 0.02).to(cfg.torch_dtype)
    return out


def _kv_stacks(caches):
    """The stacked KV caches of a decoder-only model's LayerCaches or of the
    enc-dec's DecCaches (its self-attention caches)."""
    return (caches.self_caches,) if hasattr(caches, "enc_states") else caches.caches


def _serve_logits(arch, params, batch, feed):
    """Prefill of ``batch`` and the decode steps of ``feed``; → ((batch,
    steps + 1, vocab) logits on the CPU, the caches)."""
    import torch

    out, cache = arch.prefill(params, batch, capacity=PARITY_CAPACITY)
    steps = [out]
    start = _positions(arch.cfg, batch)
    for i in range(feed.shape[0]):
        out, cache = arch.decode(params, feed[i], cache, start + i)
        steps.append(out)
    return torch.cat([x.float().cpu() for x in steps], dim=1), cache


def _card_vs_cpu(s: Smoke, cfg, hooks=None, prefill_kernel=True):
    """``cfg`` (float32) from one seed on the card and on the CPU: a prompt
    of ``PARITY_PROMPT`` positions (the VLM's 16 patch embeddings and its
    text; the enc-dec's frames beside them) and ``PARITY_GEN`` decode
    steps, each run inside ``hooks(device)`` where given.  Asserts the
    exact flash launches on the card (the float32 kernel at each attention
    layer's prefill unless ``prefill_kernel`` is False — a prefill with a
    prefix takes the plain recurrence —, the split-KV decode at each step)
    and none on the CPU, the logits (finite) and every cache within
    ``PARITY_ATOL``, the KV positions and counts equal.  → dict of the
    logits, launches, errors."""
    import numpy as np
    import torch

    from repro_torch.core.tree import tree_map
    from repro_torch.models.api import Arch

    counters = _flash_counters()
    arch = Arch(cfg)
    cpu = torch.device("cpu")
    params = {cpu: arch.init(seed=0, device=cpu)}
    params[s.dev] = tree_map(lambda x: x.to(s.dev), params[cpu])
    batch = _frontend(cfg, 1, PARITY_PROMPT)
    feed = torch.from_numpy(np.random.RandomState(1).randint(0, cfg.vocab_size,
                                                             (PARITY_GEN, 1, 1)))
    logits, caches = {}, {}
    for dev in (s.dev, cpu):
        counters.reset()
        with hooks(dev) if hooks else contextlib.nullcontext():
            logits[dev], caches[dev] = _serve_logits(
                arch, params[dev], {k: x.to(dev) for k, x in batch.items()},
                feed.to(dev))
        if dev == s.dev:
            torch.cuda.synchronize()
            launches = counters.read()
    n_attn = _attn_layers(cfg)
    n_pre = n_attn if prefill_kernel else 0
    want = {"all": n_pre + n_attn * PARITY_GEN, "prefill": 0,
            "decode": n_attn * PARITY_GEN, "f32": n_pre}
    if launches != want or any(counters.read().values()):
        raise AssertionError(f"{cfg.name}: flash launches {launches} on the card "
                             f"(expected {want}), or the CPU run launched a kernel")
    err = float((logits[s.dev] - logits[cpu]).abs().max())
    cache_err = {}
    stacks = [_kv_stacks(caches[d]) for d in (s.dev, cpu)]
    if hasattr(caches[cpu], "enc_states"):
        stacks = [(*st, c.enc_states) for st, c in zip(stacks, (caches[s.dev], caches[cpu]))]
    for st_c, st_p in zip(*stacks, strict=True):
        if torch.is_tensor(st_c):            # the enc-dec's encoder states
            d = float((st_c.cpu().float() - st_p.float()).abs().max())
            cache_err["enc_states"] = d
            continue
        for field, a, b in zip(st_c._fields, st_c, st_p):
            a = a.cpu()
            if field in ("pos", "idx"):
                if not torch.equal(a, b):
                    raise AssertionError(f"{cfg.name}: cache {field} differs")
                continue
            d = float((a.float() - b.float()).abs().max())
            cache_err[field] = max(cache_err.get(field, 0.0), d)
    if not (err <= PARITY_ATOL and bool(torch.isfinite(logits[s.dev]).all())
            and all(d <= PARITY_ATOL for d in cache_err.values())):
        raise AssertionError(f"{cfg.name}: card vs CPU logits {err}, caches "
                             f"{cache_err} (tolerance {PARITY_ATOL})")
    del params, caches
    torch.cuda.empty_cache()
    return dict(card=logits[s.dev], cpu=logits[cpu], launches=launches,
                err=err, cache_err=cache_err)


def phase_serve_parity(s: Smoke):
    """SmolLM-360M at full width, 2 layers: f32 card against CPU, then bf16
    with the kernels against bf16 with the plain version, both on the
    card.  → the float32 kernel's launches on this path."""
    import numpy as np
    import torch

    import repro_torch.models.attention as attention
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.flash_attention import flash_attention_plain
    from repro_torch.models.api import Arch

    t0 = time.perf_counter()
    counters = _flash_counters()
    cfg = dataclasses.replace(get_config(SERVE_ARCH), num_layers=PARITY_LAYERS,
                              dtype="float32")
    par = _card_vs_cpu(s, cfg)
    launches, err = par["launches"], par["err"]
    scale = float(par["cpu"].abs().max())
    top = par["card"].argmax(-1).eq(par["cpu"].argmax(-1)).all().item()
    print(f"serve parity: {cfg.name} at full width, {PARITY_LAYERS} layers, "
          f"float32, prompt {PARITY_PROMPT} + {PARITY_GEN} decode steps "
          f"(cache {PARITY_CAPACITY}): card vs CPU max |dlogits| {err!r} "
          f"(tolerance {PARITY_ATOL}; logits up to {scale!r}), caches "
          f"{json.dumps(par['cache_err'])}, same argmax {bool(top)}, flash "
          f"launches {json.dumps(launches)}, {time.perf_counter() - t0:.1f} s",
          flush=True)
    f32_launches = launches["f32"]

    # bf16: the kernels against the plain version, both on the card.
    t0 = time.perf_counter()
    cfg = dataclasses.replace(cfg, dtype="bfloat16")
    arch = Arch(cfg)
    params = arch.init(seed=0, device=s.dev)
    rng = np.random.RandomState(0)
    tokens = torch.from_numpy(rng.randint(0, cfg.vocab_size, (1, PARITY_PROMPT))).to(s.dev)
    feed = torch.from_numpy(rng.randint(0, cfg.vocab_size, (PARITY_GEN, 1, 1))).to(s.dev)
    counters.reset()
    kern, _ = _serve_logits(arch, params, {"tokens": tokens}, feed)
    torch.cuda.synchronize()
    launches = counters.read()
    blocked = attention._sdpa_blocked

    def plain_blocked(q, k, v, qpos, kpos, *, causal, window, prefix_len):
        return flash_attention_plain(q, k, v, qpos.to(torch.int32), kpos.to(torch.int32),
                                     causal=causal, window=window)
    attention._sdpa_blocked = plain_blocked
    try:
        plain, _ = _serve_logits(arch, params, {"tokens": tokens}, feed)
    finally:
        attention._sdpa_blocked = blocked
    want = {"all": PARITY_LAYERS * (1 + PARITY_GEN), "prefill": PARITY_LAYERS,
            "decode": PARITY_LAYERS * PARITY_GEN, "f32": 0}
    if launches != want or counters.read()["all"] != want["all"]:
        raise AssertionError(f"bf16 serve check: flash launches {launches}, "
                             f"expected {want} (and none from the plain run)")
    err = float((kern - plain).abs().max())
    scale = float(plain.abs().max())
    top = float(kern.argmax(-1).eq(plain.argmax(-1)).float().mean())
    if not (err <= BF16_PARITY_RTOL * scale and bool(torch.isfinite(kern).all())):
        raise AssertionError(f"bf16 serve check: kernel logits differ from the "
                             f"plain version's by {err} (limit {BF16_PARITY_RTOL} "
                             f"of {scale})")
    print(f"bf16 serve check: {cfg.name} at full width, {PARITY_LAYERS} layers, "
          f"bfloat16 on the card, prompt {PARITY_PROMPT} + {PARITY_GEN} decode "
          f"steps: kernels vs plain max |dlogits| {err!r} (limit "
          f"{BF16_PARITY_RTOL} of {scale!r}), same argmax at {top!r} of the "
          f"steps, flash launches {json.dumps(launches)}, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    del params
    torch.cuda.empty_cache()
    return f32_launches


def _serve_run(s: Smoke, cfg, batch, hooks=contextlib.nullcontext,
               prompt=SERVE_PROMPT, capacity=SERVE_CAPACITY, prefill_kernel=True):
    """``cfg`` built on the card from a seed, warmed up on a short prompt,
    then one prefill of ``prompt`` decoder positions (a frontend's
    embeddings from the seed too: the VLM's before its text, the enc-dec's
    frames into its encoder) and ``SERVE_GEN`` greedy decode steps through
    ``launch/serve.py``'s steps into a cache of ``capacity``, timed (the
    host's enqueue time beside each: equal, the step is host-bound), inside
    ``hooks()``.  Asserts the exact flash launches (one prefill launch per
    attention layer unless ``prefill_kernel`` is False, and ``SERVE_GEN``
    decode launches per attention layer) and no other kernel, the KV
    positions and counts, finite caches (KV, Mamba h and conv) and tokens
    inside the vocabulary.  → (the row, the launches, the params)."""
    import torch

    from repro_torch.core.tree import tree_leaves
    from repro_torch.launch.serve import make_decode_step, make_prefill_step
    from repro_torch.models.api import Arch

    arch = Arch(cfg)
    t0 = time.perf_counter()
    params = arch.init(seed=0, device=s.dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    leaves = tree_leaves(params)
    inputs = _frontend(cfg, batch, prompt, gen=s.gen, device=s.dev)
    prefill = make_prefill_step(arch, capacity=capacity)
    decode = make_decode_step(arch)
    # Warm-up on a short prompt (cuBLAS handles, the allocator): no flash.
    warm = {**inputs, "tokens": inputs["tokens"][:, :64]}
    tok, caches = make_prefill_step(arch, capacity=80)(params, warm)
    decode(params, tok.reshape(batch, 1), caches, _positions(cfg, warm))
    del caches
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    fns = _kernel_fns()
    counters = _flash_counters()
    with hooks():
        fns.reset()
        counters.reset()
        t0 = time.perf_counter()
        tok, caches = prefill(params, inputs)
        prefill_enqueue_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        generated = [tok]
        decode_enqueue_s = 0.0
        t0 = time.perf_counter()
        for i in range(SERVE_GEN):
            t1 = time.perf_counter()
            tok, caches = decode(params, tok.reshape(batch, 1), caches, prompt + i)
            decode_enqueue_s += time.perf_counter() - t1
            generated.append(tok.reshape(batch))
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        launches = counters.read()
        stray = fns.moved()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    n_attn = _attn_layers(cfg)
    n_pre = n_attn if prefill_kernel else 0
    want = {"all": n_pre + n_attn * SERVE_GEN, "prefill": n_pre,
            "decode": n_attn * SERVE_GEN, "f32": 0}
    if launches != want or stray:
        raise AssertionError(f"serve {cfg.name}: flash launches {launches} "
                             f"(expected {want}), other kernels {stray}")
    gen = torch.stack(generated, dim=1)
    n = prompt + SERVE_GEN
    checks = {"tokens": bool(((gen >= 0) & (gen < cfg.vocab_size)).all())}
    for st in _kv_stacks(caches):
        if hasattr(st, "idx"):
            checks["kv_positions"] = checks.get("kv_positions", True) and bool(
                (st.pos[:, :n] == torch.arange(n, device=s.dev)).all()
                and (st.pos[:, n:] == -1).all() and (st.idx == n).all())
            checks["kv_finite"] = checks.get("kv_finite", True) and bool(
                torch.isfinite(st.k).all() and torch.isfinite(st.v).all())
        else:
            checks["mamba_finite"] = checks.get("mamba_finite", True) and bool(
                torch.isfinite(st.h).all() and torch.isfinite(st.conv.float()).all())
    if not all(checks.values()):
        raise AssertionError(f"serve {cfg.name}: checks {checks}")
    row = dict(arch=cfg.name, layers=cfg.num_layers, dtype=cfg.dtype, batch=batch,
               prompt=prompt, frontend=cfg.frontend,
               frontend_embeds=inputs["embeds"].shape[1] if "embeds" in inputs else 0,
               decode_steps=SERVE_GEN, capacity=capacity,
               params=sum(w.numel() for w in leaves),
               param_gib=sum(w.numel() * w.element_size() for w in leaves) / 2**30,
               init_s=init_s, prefill_s=prefill_s,
               prompt_tokens_per_s=batch * prompt / prefill_s,
               prefill_enqueue_s=prefill_enqueue_s,
               decode_ms_per_token=decode_s / SERVE_GEN * 1e3,
               decode_enqueue_ms_per_step=decode_enqueue_s / SERVE_GEN * 1e3,
               decode_tokens_per_s=batch * SERVE_GEN / decode_s,
               peak_gib=peak_gib, flash_launches=launches, checks=checks,
               first_tokens=gen[:, :6].tolist())
    del caches, leaves
    return row, launches, params


def phase_serve(s: Smoke, flash_rows):
    """SmolLM-360M at full width and depth through the serve steps, timed."""
    import torch

    from repro_torch.configs.registry import get_config

    cfg = get_config(SERVE_ARCH)
    row, launches, params = _serve_run(s, cfg, SERVE_BATCH)
    pre, dec = flash_rows["prefill"]["ms"], flash_rows["decode"]["ms"]
    row.update(flash_ms_per_prefill_layer=pre, flash_ms_per_decode_layer=dec,
               flash_share_of_prefill=cfg.num_layers * pre / (row["prefill_s"] * 1e3),
               flash_share_of_decode=cfg.num_layers * dec / row["decode_ms_per_token"])
    print("serve: " + json.dumps(row), flush=True)
    del params
    torch.cuda.empty_cache()
    return launches


def _attn_layers(cfg):
    """Attention layers in the stack (each launches flash once a step)."""
    from repro_torch.models.lm import period_structure

    _, nper, kinds = period_structure(cfg)
    return nper * sum(kind == "attn" for kind, _ in kinds)


def phase_families_parity(s: Smoke):
    """Reduced Qwen3-MoE (k = 4 of 4, and k = 2), Falcon-Mamba and Jamba,
    float32: the prompt and decode steps of phase 9 on the card against
    the CPU, the card's MoE routes replayed on the CPU; a route that
    differs must differ at a near tie.  → flash launches."""
    import torch

    from repro_torch.configs.registry import get_config

    sys.path.insert(0, str(REPO / "tests"))
    from torch_parity import MoERoutes

    total = dict.fromkeys(_flash_counters(), 0)
    for name, over in FAMILY_PARITY:
        t0 = time.perf_counter()
        cfg = dataclasses.replace(get_config(name).reduced(), **over)
        routes, dropped = MoERoutes(), {"card": [], "cpu": []}

        @contextlib.contextmanager
        def hooks(dev):
            side = "card" if dev.type == "cuda" else "cpu"
            with routes.use("record" if side == "card" else "replay"), \
                    _moe_spy(dropped[side]):
                yield

        par = _card_vs_cpu(s, cfg, hooks)
        routes.check(f"family parity {cfg.name} {over}")
        drops = [float(d) for d in dropped["card"]]
        if not (len(drops) == len(dropped["cpu"])
                and all(abs(a - float(b)) <= 1e-6 for a, b in zip(drops, dropped["cpu"]))
                and ("experts_per_token" not in over or max(drops) > 0)):
            raise AssertionError(f"family parity {cfg.name} {over}: dropped "
                                 f"fractions {drops} on the card (the CPU's, on the "
                                 "same routes, must match; k = 2 must drop)")
        row = dict(arch=cfg.name, over=over, layers=cfg.num_layers,
                   experts=cfg.num_experts, k=cfg.experts_per_token,
                   prompt=PARITY_PROMPT, decode_steps=PARITY_GEN,
                   max_abs_dlogits=par["err"], logits_scale=float(par["cpu"].abs().max()),
                   max_abs_dcache=par["cache_err"], tolerance=PARITY_ATOL,
                   moe_calls=len(routes.recorded), route_tokens=routes.tokens,
                   moe_dropped_frac_prefill=drops,
                   routes_differ=routes.differ,
                   max_logit_margin_at_difference=routes.margin,
                   near_tie=routes.NEAR_TIE,
                   flash_launches=par["launches"], s=time.perf_counter() - t0)
        print("family parity: " + json.dumps(row), flush=True)
        for k in total:
            total[k] += par["launches"][k]
    return total


@contextlib.contextmanager
def _moe_spy(dropped, layer_in=None):
    """Inside the block, ``lm.moe_ffn`` (the LM calls it through its module
    global) appends each capacity-limited call's dropped fraction to
    ``dropped`` and keeps the first such call's params and input in
    ``layer_in["moe"]``."""
    import repro_torch.models.lm as lm

    moe_ffn = lm.moe_ffn

    def spy(params, x, cfg, dropless=False, **kw):
        y, aux = moe_ffn(params, x, cfg, dropless=dropless, **kw)
        if not dropless:
            dropped.append(aux["moe_dropped_frac"])
            if layer_in is not None:
                layer_in.setdefault("moe", (params, x))
        return y, aux

    lm.moe_ffn = spy
    try:
        yield
    finally:
        lm.moe_ffn = moe_ffn


def _time_layers(s: Smoke, cfg, moe_in, mamba_in, moe_ffn, mamba_block):
    """One layer alone (CUDA events), on the params and input it had in the
    serve run: the MoE FFN at prefill (capacity dispatch) and at a decode
    step (dropless: every expert's weights read, beside that read's bytes
    bound), and the Mamba block at prefill."""
    layer = {}
    if moe_in is not None:
        p, x = moe_in
        layer["moe_prefill_layer_ms"] = s.time_ms(lambda: moe_ffn(p, x, cfg),
                                                  reps=3, warmup=1)
        layer["moe_decode_layer_ms"] = s.time_ms(
            lambda: moe_ffn(p, x[:, -1:], cfg, dropless=True), reps=20)
        layer["moe_decode_layer_bound_ms"] = sum(
            p[key].numel() * p[key].element_size()
            for key in ("w_gate", "w_up", "w_down")) / HBM_BYTES_PER_S * 1e3
    if mamba_in is not None:
        p, x = mamba_in
        layer["mamba_prefill_layer_ms"] = s.time_ms(lambda: mamba_block(p, x, cfg),
                                                    reps=2, warmup=1)
    return layer


def phase_families_serve(s: Smoke):
    """Qwen3-MoE-30B-A3B (48 layers) and Falcon-Mamba-7B (64 layers) at full
    width and depth, Jamba-v0.1-52B at full width over 2 of its 4 periods,
    bf16, through the serve steps; then flash on the first attention
    layer's own q, k, v of each prefill and of each first decode step.
    → flash launches."""
    import torch

    import repro_torch.models.attention as attention
    import repro_torch.models.lm as lm
    from repro_torch.configs.registry import get_config

    t_all = time.perf_counter()
    total = dict.fromkeys(_flash_counters(), 0)
    captured = []
    for name, layers in FAMILY_SERVE:
        t_phase = time.perf_counter()
        full = get_config(name)
        cfg = full if layers is None else dataclasses.replace(full, num_layers=layers)
        # The first attention layer's inputs at prefill and at the first
        # decode step (copied: the decode reads the cache, which later
        # steps write), for the flash check; each MoE layer's dropped
        # fraction at prefill (moe_ffn's aux); the first MoE and Mamba
        # layers' prefill params and inputs, timed alone after the run.
        blocked, mamba_block = attention._sdpa_blocked, lm.mamba_block
        dropped, layer_in = [], {}

        def capture(q, k, v, qpos, kpos, *, causal, window, prefix_len):
            step = "prefill" if q.shape[1] > 1 else "decode"
            if (name, step) not in [c[:2] for c in captured]:
                captured.append((name, step, *(t.clone() for t in (q, k, v, qpos, kpos)),
                                 window))
            return blocked(q, k, v, qpos, kpos, causal=causal, window=window,
                           prefix_len=prefix_len)

        def mamba_in(params_, x, cfg_, **kw):
            layer_in.setdefault("mamba", (params_, x))
            return mamba_block(params_, x, cfg_, **kw)

        @contextlib.contextmanager
        def hooks():
            attention._sdpa_blocked, lm.mamba_block = capture, mamba_in
            try:
                with _moe_spy(dropped, layer_in):
                    yield
            finally:
                attention._sdpa_blocked, lm.mamba_block = blocked, mamba_block

        row, launches, params = _serve_run(s, cfg, FAMILY_BATCH, hooks)
        layer = _time_layers(s, cfg, layer_in.pop("moe", None),
                             layer_in.pop("mamba", None), lm.moe_ffn, mamba_block)
        # Dropless decode runs every expert on each step: it reads all
        # expert weights (bound below) where the routed k need k/E of them.
        moe_bytes = sum(w.numel() * w.element_size() for sub in params["period"]
                        for key, w in sub.get("ffn", {}).items()
                        if key in ("w_gate", "w_up", "w_down") and torch.is_tensor(w))
        plen = lm.period_structure(full)[0]
        row.update(full_layers=full.num_layers,
                   cut=(None if layers is None else
                        f"depth {full.num_layers} -> {layers} layers "
                        f"({layers // plen} of {full.num_layers // plen} periods)"),
                   expert_gib=moe_bytes / 2**30,
                   decode_expert_bound_ms=moe_bytes / HBM_BYTES_PER_S * 1e3,
                   decode_routed_bound_ms=(moe_bytes / HBM_BYTES_PER_S * 1e3
                                           * cfg.experts_per_token / cfg.num_experts
                                           if cfg.num_experts else 0.0),
                   moe_dropped_frac_prefill=(float(torch.stack(dropped).mean())
                                             if dropped else None),
                   moe_dropped_frac_max=(float(torch.stack(dropped).max())
                                         if dropped else None),
                   **layer, s=time.perf_counter() - t_phase)
        print("family serve: " + json.dumps(row), flush=True)
        for k in total:
            total[k] += launches[k]
        del params, layer_in, dropped
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    s.group = ("flash attention at phase 17's shapes: the first attention "
               "layer's q, k, v of each full-width prefill and first decode step")
    for name, step, q, k, v, qpos, kpos, window in captured:
        s.check_flash_on(q, k, v, qpos.to(torch.int32), kpos.to(torch.int32), window)
    want = [(n, step) for n, _ in FAMILY_SERVE if n != "falcon-mamba-7b"
            for step in ("prefill", "decode")]
    if [c[:2] for c in captured] != want:
        raise AssertionError(f"family serve: captured {[c[:2] for c in captured]}, "
                             f"expected {want}")
    s.report()
    del captured
    torch.cuda.empty_cache()
    print(f"family flash check: {time.perf_counter() - t0:.1f} s; family serve "
          f"in all {time.perf_counter() - t_all:.1f} s", flush=True)
    return total


def _train_counters():
    """The launch counters the training slice may move, by kernel."""
    return Launches({**_kernel_fns(), "flash_bwd": "flash_bwd.launches",
                     **{f"flash_{k}": c for k, c in _flash_counters().items()}})


def phase_train_kernels(s: Smoke):
    """The FedScalar/QSGD kernels on bf16 leaves at SmolLM-360M's shapes."""
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.core.projection import leaf_layout
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.models.api import Arch

    t0 = time.perf_counter()
    n0 = s.checks
    params = Arch(get_config(TRAIN_ARCH)).init(seed=1, device=s.dev)
    layout = leaf_layout(params)
    zero = torch.zeros(1, device=s.dev)
    big = ((49152, 960), (81920, 960))
    s.group = ("train kernels, bf16, SmolLM-360M's 11 leaves (rademacher; "
               "encode N=1, decode and fused close N=4, QSGD N=1 bits 8)")
    for ll, w in zip(layout, tree_leaves(params)):
        x2d = w.reshape(ll.rows, ll.cols)
        hi = zero + float(ll.size)
        delta = (s.randn(1, ll.rows, ll.cols) * 1e-3).to(torch.bfloat16)
        sd, rs = s.seeds(TRAIN_CLIENTS), s.randn(TRAIN_CLIENTS, 1) * 0.3
        what = f"train leaf {ll.shape} as {ll.rows}x{ll.cols}"
        s.check_encode(delta, s.seeds(1), ll.tag, zero, hi, "rademacher", False,
                       what=what)
        s.check_rec(x2d, sd, rs, ll.tag, 1.0 / TRAIN_CLIENTS, "rademacher", zero,
                    hi, False, what=what)
        s.check_fused(x2d, sd, rs, ll.tag, 1.0 / TRAIN_CLIENTS, "rademacher",
                      zero, hi, False, what=what)
        s.check_qsgd(delta, s.seeds(1), 8, what=what)
    s.report()
    s.group = ("train kernels, bf16, all families at the embedding (49152x960) "
               "and the stacked FFN leaf (32, 2560, 960) as 81920x960; QSGD bits 2, 4")
    for ll, w in zip(layout, tree_leaves(params)):
        if (ll.rows, ll.cols) not in big:
            continue
        x2d = w.reshape(ll.rows, ll.cols)
        hi = zero + float(ll.size)
        delta = (s.randn(1, ll.rows, ll.cols) * 1e-3).to(torch.bfloat16)
        for family in FAMILIES:
            sd, rs = s.seeds(TRAIN_CLIENTS), s.randn(TRAIN_CLIENTS, 1) * 0.3
            what = f"train leaf {ll.shape} {family}"
            s.check_encode(delta, s.seeds(1), ll.tag, zero, hi, family, False,
                           what=what)
            s.check_rec(x2d, sd, rs, ll.tag, 1.0 / TRAIN_CLIENTS, family, zero,
                        hi, False, what=what)
            s.check_fused(x2d, sd, rs, ll.tag, 1.0 / TRAIN_CLIENTS, family, zero,
                          hi, False, what=what)
        for bits in (2, 4):
            s.check_qsgd(delta, s.seeds(1), bits, what=f"train leaf {ll.shape}")
        del delta
    s.report()
    s.group = ("train tree launches, bf16: SmolLM-360M's 11 leaves in one launch "
               "(rademacher, hadamard; encode N=1 k=1 and FULL 8, close N=4 k=1; "
               "QSGD N=1 bits 8 and 4, norms in the kernel), and its 2-layer "
               "leaves under 2**24 elements (10 leaves; BLOCK 8)")
    deltas = [(s.randn(1, *w.shape) * 1e-3).to(torch.bfloat16)
              for w in tree_leaves(params)]
    for bits in (8, 4):
        s.check_qsgd_tree(deltas, s.seeds(1), bits,
                          what=f"smollm-360m 11 leaves b={bits}")
    del deltas
    torch.cuda.empty_cache()
    for family in ("rademacher", "hadamard"):
        deltas = tree_map(lambda w: (s.randn(1, *w.shape) * 1e-3).to(torch.bfloat16),
                          params)
        for k in (1, 8):
            s.check_tree_encode(deltas, s.seeds(1), family, k, "full",
                                f"smollm-360m 11 leaves {family} k={k}")
        del deltas
        s.check_tree_close(params, s.seeds(TRAIN_CLIENTS),
                           s.randn(TRAIN_CLIENTS, 1) * 0.3, family, 1, "full",
                           f"smollm-360m 11 leaves {family}")
        torch.cuda.empty_cache()
    small = Arch(dataclasses.replace(get_config(TRAIN_ARCH), num_layers=2,
                                     dtype="bfloat16")).init(seed=2, device=s.dev)
    small = {f"l{i:02d}": w for i, w in enumerate(tree_leaves(small))
             if w.numel() <= 1 << 24}
    for family in ("rademacher", "hadamard"):
        deltas = {key: (s.randn(1, *w.shape) * 1e-3).to(torch.bfloat16)
                  for key, w in small.items()}
        s.check_tree_encode(deltas, s.seeds(1), family, 8, "block",
                            f"smollm-360m 2-layer {len(small)} leaves {family} BLOCK 8")
        s.check_tree_close(small, s.seeds(TRAIN_CLIENTS),
                           s.randn(TRAIN_CLIENTS, 8) * 0.3, family, 8, "block",
                           f"smollm-360m 2-layer {len(small)} leaves {family} BLOCK 8")
    s.report()
    del params, small
    torch.cuda.empty_cache()
    print(f"train kernels (bf16): all {s.checks - n0} checks ok in "
          f"{time.perf_counter() - t0:.1f} s (at most {s.enc_ratio!r} of the "
          "encode's tolerance over the run)", flush=True)


def phase_train_parity(s: Smoke):
    """SmolLM-360M at full width, 2 layers, float32: one train_step round on
    the card (its attention through the flash training kernels) against the
    same round on the CPU → the card's launches."""
    import numpy as np
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.launch.train import FLRunConfig, make_train_step
    from repro_torch.models.api import Arch

    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), num_layers=TRAIN_PARITY_LAYERS,
                              dtype="float32")
    arch = Arch(cfg)
    cpu = torch.device("cpu")
    params = {cpu: arch.init(seed=0, device=cpu)}
    params[s.dev] = tree_map(lambda x: x.to(s.dev), params[cpu])
    n, st = TRAIN_CLIENTS, TRAIN_STEPS
    toks = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (n * st * TRAIN_PER_STEP, TRAIN_PARITY_SEQ + 1)))
    step = make_train_step(arch, FLRunConfig(num_virtual_clients=n, local_steps=st,
                                             local_lr=TRAIN_LR, server_lr=1.0))
    counters = _train_counters()
    out, launches, secs = {}, {}, {}
    for dev in (s.dev, cpu):
        counters.reset()
        t1 = time.perf_counter()
        batch = {"tokens": toks[:, :-1].to(dev), "labels": toks[:, 1:].to(dev)}
        out[dev] = step(params[dev], batch, 0)
        if dev == s.dev:
            torch.cuda.synchronize()
        secs[dev.type] = time.perf_counter() - t1
        launches[dev.type] = counters.moved()
    # the encode: one tree launch (and its reduction) per client; the close:
    # one tree launch; float32 attention under autograd: the flash kernel in
    # each layer's forward and its recompute, its backward once, a step
    calls = n * st * cfg.num_layers
    want = {"encode": 2 * n, "rec": 1, "flash_f32": 2 * calls, "flash_bwd": calls}
    if launches != {"cuda": want, "cpu": {}}:
        raise AssertionError(f"train parity: launches {launches}, expected "
                             f"{want} on the card and none on the CPU")
    (p_g, m_g), (p_c, m_c) = out[s.dev], out[cpu]
    dloss = abs(float(m_g["loss"]) - float(m_c["loss"]))
    r_g, r_c = m_g["r"].cpu().double(), m_c["r"].double()
    norm = float(torch.sqrt(sum((w.double() ** 2).sum() for w in tree_leaves(params[cpu]))))
    r_tol = TRAIN_R_ULPS * st * 2.0 ** -24 * norm + TRAIN_R_RTOL * r_c.abs()
    dr = (r_g - r_c).abs()
    p_tol = float(dr.sum()) / n + 1e-6
    dp = max(float((a.cpu() - b).abs().max())
             for a, b in zip(tree_leaves(p_g), tree_leaves(p_c)))
    finite = all(bool(torch.isfinite(w).all()) for w in tree_leaves(p_g))
    if not (dloss <= TRAIN_LOSS_ATOL and bool((dr <= r_tol).all()) and dp <= p_tol
            and finite and torch.equal(m_g["seeds"].cpu(), m_c["seeds"])):
        raise AssertionError(
            f"train parity: card vs CPU |dloss| {dloss} (limit {TRAIN_LOSS_ATOL}), "
            f"|dr| {dr.flatten().tolist()} (limits {r_tol.flatten().tolist()}), "
            f"|dparams| {dp} (limit {p_tol}), finite {finite}")
    print("train parity: " + json.dumps(dict(
        arch=cfg.name, layers=cfg.num_layers, dtype=cfg.dtype, clients=n,
        local_steps=st, per_step_batch=TRAIN_PER_STEP, seq=TRAIN_PARITY_SEQ,
        loss_card=float(m_g["loss"]), loss_cpu=float(m_c["loss"]),
        abs_dloss=dloss, loss_limit=TRAIN_LOSS_ATOL,
        r_card=r_g.flatten().tolist(), r_cpu=r_c.flatten().tolist(),
        max_dr_over_limit=float((dr / r_tol).max()),
        max_abs_dparams=dp, dparams_limit=p_tol, launches_card=launches["cuda"],
        card_s=secs["cuda"], cpu_s=secs["cpu"],
        total_s=time.perf_counter() - t0)), flush=True)
    del out, params
    torch.cuda.empty_cache()
    return launches["cuda"]


def phase_train_long(s: Smoke):
    """Training above the blocked-attention threshold on the card (C2):
    SmolLM-360M at full width, 2 layers, float32, one sequence of
    TRAIN_LONG_SEQ tokens; the loss and every gradient through
    ``_sdpa_blocked`` against the same through the plain ``_sdpa`` with its
    flash route turned off, twice: as float32 runs (FlashAttentionF32, the
    flash kernel forward and its backward, never the blocked recurrence),
    and with the flash route turned off, as bf16 training and prefix
    prefills run (the reference's blocked recurrence in plain torch, under
    autograd) → the flash training launches."""
    import numpy as np
    import torch

    import repro_torch.models.attention as attention
    from repro_torch.configs.registry import get_config
    from repro_torch.core.tree import tree_leaves, tree_unflatten
    from repro_torch.models.api import Arch

    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), num_layers=TRAIN_PARITY_LAYERS,
                              dtype="float32")
    arch = Arch(cfg)
    params = arch.init(seed=3, device=s.dev)
    toks = torch.from_numpy(np.random.RandomState(3).randint(
        0, cfg.vocab_size, (1, TRAIN_LONG_SEQ + 1))).to(s.dev)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    counters = _flash_counters()
    plain_blocked, route = attention._sdpa_blocked_plain, attention._flash_train_route
    threshold = attention.BLOCKED_SDPA_THRESHOLD
    calls = [0]

    def counted(*args, **kwargs):
        calls[0] += 1
        return plain_blocked(*args, **kwargs)

    def flash_train():
        t = _totals()
        return {n: t[n] for n in ("flash_train.calls", "flash_bwd.launches")}

    def loss_and_grads():
        leaves = [w.detach().requires_grad_(True) for w in tree_leaves(params)]
        p = tree_unflatten(params, leaves)
        loss = arch.loss(p, batch)
        grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        return float(loss.detach()), grads

    def run(flash_route):
        """→ (loss and grads through ``_sdpa_blocked``, its seconds, the
        blocked recurrence's calls, the flash launches, the flash training
        counts)."""
        counters.reset()
        before = flash_train()
        calls[0] = 0
        attention._sdpa_blocked_plain = counted
        if not flash_route:
            attention._flash_train_route = lambda *a: False
        try:
            t1 = time.perf_counter()
            out = loss_and_grads()
            secs = time.perf_counter() - t1
        finally:
            attention._sdpa_blocked_plain = plain_blocked
            attention._flash_train_route = route
        return (out, secs, calls[0], counters.moved(),
                {n: c - before[n] for n, c in flash_train().items()})

    flash, flash_s, flash_calls, flash_launches, trained = run(True)
    blocked, blocked_s, blocked_calls, blocked_launches, blocked_trained = run(False)
    attention.BLOCKED_SDPA_THRESHOLD = TRAIN_LONG_SEQ + 1
    attention._flash_train_route = lambda *a: False
    try:
        t1 = time.perf_counter()
        plain = loss_and_grads()
        plain_s = time.perf_counter() - t1
    finally:
        attention.BLOCKED_SDPA_THRESHOLD = threshold
        attention._flash_train_route = route
    # forward and the recomputation in the backward (remat), per layer; one
    # backward per layer; flash_attention (no grad) never
    layers = cfg.num_layers
    want = {"flash_train.calls": 2 * layers, "flash_bwd.launches": layers}
    none = dict.fromkeys(want, 0)
    if (flash_calls or trained != want or flash_launches != {"f32": 2 * layers}
            or blocked_calls != 2 * layers or blocked_trained != none or blocked_launches):
        raise AssertionError(
            f"train long: flash route: blocked recurrence taken {flash_calls} times "
            f"(expected 0), flash training {trained} (expected {want}), flash "
            f"launches {flash_launches}; route off: blocked recurrence taken "
            f"{blocked_calls} times (expected {2 * layers}), flash training "
            f"{blocked_trained}, flash launches {blocked_launches} (expected none)")
    rows = {}
    for name, (loss, grads) in (("flash", flash), ("blocked", blocked)):
        worst = max(float((a - b).abs().max()) / float(b.abs().max())
                    for a, b in zip(grads, plain[1]))
        dloss = abs(loss - plain[0])
        if not (dloss <= TRAIN_LONG_LOSS_ATOL and worst <= TRAIN_LONG_GRAD_RTOL
                and all(bool(torch.isfinite(g).all()) for g in grads)):
            raise AssertionError(f"train long ({name}): |dloss| {dloss} (limit "
                                 f"{TRAIN_LONG_LOSS_ATOL}), worst gradient "
                                 f"{worst} of its leaf's largest (limit "
                                 f"{TRAIN_LONG_GRAD_RTOL})")
        rows[name] = dict(loss=loss, abs_dloss=dloss, max_grad_err_over_leaf_max=worst)
    print("train long: " + json.dumps(dict(
        arch=cfg.name, layers=layers, dtype=cfg.dtype, seq=TRAIN_LONG_SEQ,
        threshold=threshold, loss_plain=plain[0], loss_limit=TRAIN_LONG_LOSS_ATOL,
        grad_limit=TRAIN_LONG_GRAD_RTOL, flash=dict(rows["flash"], flash_train=trained,
                                                     s=flash_s),
        blocked=dict(rows["blocked"], blocked_recurrence_calls=blocked_calls,
                     s=blocked_s),
        plain_s=plain_s, total_s=time.perf_counter() - t0)), flush=True)
    del params, flash, blocked, plain
    torch.cuda.empty_cache()
    return {"flash_f32": flash_launches["f32"], "flash_bwd": trained["flash_bwd.launches"]}


def phase_train(s: Smoke):
    """SmolLM-360M at full width and depth through launch/train.py, timed."""
    import shutil
    import tempfile

    import torch

    import repro_torch.kernels.ops as ops
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.configs.registry import get_config
    from repro_torch.core.projection import leaf_layout
    from repro_torch.core.tree import tree_leaves
    from repro_torch.launch.train import FLRunConfig, make_train_step
    from repro_torch.models.api import Arch

    cfg = get_config(TRAIN_ARCH)
    arch = Arch(cfg)
    t0 = time.perf_counter()
    params = arch.init(seed=0, device=s.dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    layout = leaf_layout(params)
    shapes = [(ll.rows, ll.cols) for ll in layout]
    d = sum(ll.size for ll in layout)
    n, st = TRAIN_CLIENTS, TRAIN_STEPS
    gb = n * st * TRAIN_PER_STEP
    step = make_train_step(arch, FLRunConfig(num_virtual_clients=n, local_steps=st,
                                             local_lr=TRAIN_LR, server_lr=1.0))
    enc_b, enc_by = _encode_bound(shapes, n, 1, elem=2)
    close_b, close_by = _fused_bound(shapes, n, 1, elem=2)

    # CUDA events around the round's encode and close calls, read after it.
    events = {"encode": [], "close": []}

    def timed(name, fn):
        def call(*args, **kwargs):
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
            out = fn(*args, **kwargs)
            e1.record()
            events[name].append((e0, e1))
            return out
        return call

    originals = (ops.project_tree_kernel, ops.server_update_kernel)
    ops.project_tree_kernel = timed("encode", originals[0])
    ops.server_update_kernel = timed("close", originals[1])
    counters = _train_counters()
    rows, close_check = [], None
    try:
        counters.reset()
        for rnd in range(1 + TRAIN_ROUNDS):
            toks = torch.randint(0, cfg.vocab_size, (gb, TRAIN_SEQ + 1),
                                 generator=s.gen, device=s.dev)
            batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
            for v in events.values():
                v.clear()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            new, m = step(params, batch, rnd)
            torch.cuda.synchronize()
            round_s = time.perf_counter() - t1
            enc_ms = sum(a.elapsed_time(b) for a, b in events["encode"])
            close_ms = sum(a.elapsed_time(b) for a, b in events["close"])
            row = dict(round=rnd, warmup=rnd == 0, round_s=round_s,
                       local_sgd_s=round_s - (enc_ms + close_ms) / 1e3,
                       train_tokens_per_s=gb * TRAIN_SEQ / round_s,
                       encode_ms=enc_ms, encode_bound_ms=enc_b, encode_bound_by=enc_by,
                       close_ms=close_ms, close_bound_ms=close_b,
                       close_bound_by=close_by, loss=float(m["loss"]),
                       r_rms=float(m["r_rms"]),
                       uploaded_scalars=m["uploaded_scalars"])
            print("train: " + json.dumps(row), flush=True)
            rows.append(row)
            if rnd == 0:
                close_check = _train_close_check(s, params, new, m, layout)
                torch.cuda.reset_peak_memory_stats()
            params = new
        launches = counters.moved()
    finally:
        ops.project_tree_kernel, ops.server_update_kernel = originals
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    rounds = 1 + TRAIN_ROUNDS
    want = {"encode": 2 * n * rounds, "rec": rounds}   # one close launch a round
    if launches != want:
        raise AssertionError(f"train: launches {launches}, expected {want}")
    if not (all(r["uploaded_scalars"] == 2 * n for r in rows)
            and all(w.dtype == torch.bfloat16 for w in tree_leaves(params))
            and math.isfinite(rows[0]["loss"])):
        raise AssertionError(f"train: wrong uploads, dtypes or warm-up loss {rows[0]}")

    kernel_only = _train_kernel_times(s, params, layout)

    # Checkpoint: save and restore the trained bf16 model, bit for bit.
    out_dir = REPO / "checkpoints"           # git-ignored
    out_dir.mkdir(exist_ok=True)
    ckpt = tempfile.mkdtemp(prefix="train_ckpt_", dir=out_dir)
    try:
        t1 = time.perf_counter()
        save_checkpoint(ckpt, params, step=rounds, metadata={"arch": cfg.name})
        save_s = time.perf_counter() - t1
        restored, ck_step, meta = restore_checkpoint(ckpt, params, device=s.dev)
        restore_s = time.perf_counter() - t1 - save_s
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    same = all(torch.equal(a.view(torch.int16), b.view(torch.int16))
               for a, b in zip(tree_leaves(restored), tree_leaves(params)))
    if not (same and ck_step == rounds and meta == {"arch": cfg.name}):
        raise AssertionError("train: checkpoint did not restore bit for bit")
    timed_rows = rows[1:]
    summary = dict(
        arch=cfg.name, layers=cfg.num_layers, dtype=cfg.dtype, d=d,
        leaves=len(layout), clients=n, local_steps=st,
        per_step_batch=TRAIN_PER_STEP, seq=TRAIN_SEQ, local_lr=TRAIN_LR,
        timed_rounds=TRAIN_ROUNDS, init_s=init_s,
        round_s=[r["round_s"] for r in timed_rows],
        local_sgd_s=[r["local_sgd_s"] for r in timed_rows],
        train_tokens_per_s=[r["train_tokens_per_s"] for r in timed_rows],
        encode_ms=[r["encode_ms"] for r in timed_rows], encode_bound_ms=enc_b,
        close_ms=[r["close_ms"] for r in timed_rows], close_bound_ms=close_b,
        kernel_share_of_round=[(r["encode_ms"] + r["close_ms"]) / (r["round_s"] * 1e3)
                               for r in timed_rows],
        kernel_only=kernel_only,
        launches=launches, peak_gib=peak_gib, close_check=close_check,
        checkpoint=dict(save_s=save_s, restore_s=restore_s, bitwise=same))
    print("train summary: " + json.dumps(summary), flush=True)
    del params, restored, new
    torch.cuda.empty_cache()
    return launches


def _device_ms(fns, reps=3):
    """Device time of one pass over ``fns`` (CUDA events), the host kept out
    of it: a ~0.1 s spin kernel holds the stream while the host queues every
    launch, so the events time the kernels alone."""
    import torch

    for fn in fns:
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(200_000_000)
    start.record()
    for _ in range(reps):
        for fn in fns:
            fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _enqueue_ms(fn, reps=5):
    """The host's time to enqueue one call of ``fn`` (no wait for the device),
    the least of ``reps`` calls after a warm-up."""
    import torch

    fn()
    best = math.inf
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    torch.cuda.synchronize()
    return best * 1e3


def _train_kernel_times(s, params, layout):
    """The round's encode and close split into the kernels' device time (one
    client's tree encode, and the close over the 11 leaves in the train
    step's per-client-rounding mode, ``_device_ms``) and the host's enqueue
    time of one call; the plain versions' times at the same shapes beside
    them."""
    import torch

    from repro_torch.core.prng import Distribution
    from repro_torch.core.projection import ProjectionMode
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.kernels import ops
    from repro_torch.kernels.seeded_projection import project_tree_plain
    from repro_torch.kernels.seeded_reconstruct import reconstruct_plain
    from repro_torch.kernels.tree import tree_plan

    n = TRAIN_CLIENTS
    sd1, sdn, rs = s.seeds(1), s.seeds(n), s.randn(n, 1) * 0.3
    delta = tree_map(lambda w: w.unsqueeze(0), params)
    leaves = tree_leaves(delta)
    plan = tree_plan("encode", [ll.shape for ll in layout], [w.dtype for w in leaves],
                     1, ProjectionMode.FULL, s.dev)
    rd = Distribution.RADEMACHER

    def enc():
        ops.project_tree_kernel(delta, sd1)

    def close():
        ops.server_update_kernel(params, rs, sdn, 1.0, rd, per_client_rounding=True)

    enc_plain = s.time_ms(lambda: project_tree_plain(leaves, sd1, plan), reps=1,
                          warmup=0)
    close_plain = 0.0
    for ll, w in zip(layout, tree_leaves(params)):
        x2d = w.reshape(ll.rows, ll.cols)
        close_plain += s.time_ms(lambda: reconstruct_plain(
            x2d, sdn, rs, ll.tag, 1.0, None, None, per_client_rounding=True,
            div=float(n)), reps=1, warmup=0)
    enc_dev, close_dev = _device_ms([enc]), _device_ms([close])
    return dict(encode_device_ms_per_client=enc_dev,
                encode_device_ms_per_round=n * enc_dev,
                encode_enqueue_ms_per_client=_enqueue_ms(enc),
                encode_plain_ms_per_client=enc_plain,
                close_device_ms=close_dev, close_enqueue_ms=_enqueue_ms(close),
                close_plain_ms=close_plain)


def _train_close_check(s, params, new, metrics, layout):
    """The round's close (per-client rounding, C4) held bitwise against the
    port's plain ``server_aggregate`` on the card and against the kernel's
    plain version, given that round's params, rs and seeds."""
    import torch

    from repro_torch.core.fedscalar import FedScalarConfig, server_aggregate
    from repro_torch.core.tree import tree_leaves
    from repro_torch.kernels.seeded_reconstruct import reconstruct_plain

    rs, seeds = metrics["r"], metrics["seeds"]
    agg = tree_leaves(server_aggregate(params, rs, seeds,
                                       FedScalarConfig(server_lr=1.0)))
    for ll, x, y, a in zip(layout, tree_leaves(params), tree_leaves(new), agg):
        if not torch.equal(y, a):
            raise AssertionError(f"train: the close differs from server_aggregate "
                                 f"at leaf {ll.tag} {ll.shape}")
        want = reconstruct_plain(x.reshape(ll.rows, ll.cols), seeds, rs, ll.tag, 1.0,
                                 None, None, per_client_rounding=True,
                                 div=float(rs.shape[0]))
        if not torch.equal(y.reshape(ll.rows, ll.cols), want):
            raise AssertionError(f"train: the close differs from its plain "
                                 f"version at leaf {ll.tag} {ll.shape}")
    del agg
    torch.cuda.synchronize()
    return dict(leaves=len(layout), bitwise_server_aggregate=True,
                bitwise_plain=True)


# ---------------------------------------------------------------------------
# Phase 16: the mesh-sharded federation server (sharding/fed_rules.py)
# ---------------------------------------------------------------------------

SHARD_COUNTS = (1, 2, 4, 8)            # the resident loop and the reference shape
SHARD_CHECK_COUNTS = (1, 3, 8)         # kernel against plain (3: uneven padding)
SHARD_N = 256                          # the resident loop's cohort
SHARD_REF_DIMS, SHARD_REF_ROWS = (1 << 18, 1 << 20), 512
SHARD_REF_COHORTS = (64, 256)          # benchmarks/run.py:421-441's shape
MESH_SHAPE, MESH_SCHED_ROUNDS = (2, 4), 3


def _shard_groups(num_shards, num_leaves):
    from repro_torch.kernels.tree import MAX_TREE_LEAVES

    return -(-num_shards * num_leaves // MAX_TREE_LEAVES)


def _check_sharded(s: Smoke, params, n, family, k, mode, shards, what):
    """On a (1, shards) mesh of the card: the sharded decode and fused close
    (one launch per 64 (shard, leaf) entries) against their plain versions
    over the same shard plan and, bitwise, against the unsharded kernels;
    the sharded encode against the unsharded tree's plain version summed in
    float64, within ``tree_encode_tolerance`` of the shards' local views,
    the same bits on a rerun."""
    import torch

    from repro_torch.core.prng import Distribution
    from repro_torch.core.projection import ProjectionMode
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.kernels import ops
    from repro_torch.kernels.seeded_projection import (
        project_tree_plain,
        tree_encode_tolerance,
    )
    from repro_torch.kernels.tree import tree_plan
    from repro_torch.launch.mesh import make_fed_mesh
    from repro_torch.sharding import fed_rules as fr

    dist, pm = Distribution(family), ProjectionMode(mode)
    mesh = make_fed_mesh((1, shards))
    plan = fr.plan_tree(params, shards)
    leaves = tree_leaves(params)
    groups = _shard_groups(shards, len(leaves))
    counters = _kernel_fns()
    seeds, rs = s.seeds(n), s.randn(n, k) * 0.3
    what = f"{what} S={shards} {family} k={k} {mode}"
    for fused in (False, True):
        name = "fused" if fused else "rec"
        before = counters.read()[name]
        got = tree_leaves(fr.sharded_server_update(mesh, params, rs, seeds, 0.9, dist,
                                                   mode=pm, plan=plan,
                                                   use_fused=fused))
        launches = counters.read()[name] - before
        want = tree_leaves(fr.sharded_server_update(mesh, params, rs, seeds, 0.9,
                                                    dist, mode=pm, plan=plan,
                                                    use_kernel=False,
                                                    use_fused=fused))
        flat = tree_leaves((ops.server_update_fused if fused else
                            ops.server_update_kernel)(params, rs, seeds, 0.9, dist,
                                                      mode=pm))
        torch.cuda.synchronize()
        if launches != groups:
            raise AssertionError(f"sharded {name}: {launches} launches for "
                                 f"{groups} groups: {what}")
        err, same = 0.0, True
        for g, w, f in zip(got, want, flat):
            err = max(err, float((g.float() - w.float()).abs().max()))
            same = same and bool(torch.equal(g, w))
            if not (_decode_agrees(family, g, w) and torch.equal(g, f)
                    and bool(torch.isfinite(g).all())):
                raise AssertionError(f"sharded {name} disagrees: {what} max err "
                                     f"{err}, equal to the unsharded kernel "
                                     f"{bool(torch.equal(g, f))}")
        s._record(name, family, err, same)
    delta = tree_map(lambda w: (w.float() * 1e-2).to(w.dtype), params)
    seed = s.seeds(1)
    before = counters.read()["encode"]
    got = fr.sharded_project_tree(mesh, delta, seed, dist, k, pm, plan=plan)
    again = fr.sharded_project_tree(mesh, delta, seed, dist, k, pm, plan=plan)
    launches = counters.read()["encode"] - before
    dl = tree_leaves(delta)
    uplan = tree_plan("encode", [tuple(x.shape) for x in dl], [x.dtype for x in dl],
                      k, pm, s.dev)
    exact = project_tree_plain([x[None] for x in dl], seed, uplan, family,
                               dtype=torch.float64)[0]
    views = [x[None] for ls, v in zip(plan.leaves, fr.to_sharded_2d(delta, plan))
             for x in fr._split(v, ls, mesh)]
    tol = tree_encode_tolerance(views, family)[0]
    torch.cuda.synchronize()
    if launches != 4 * groups or not torch.equal(got, again):
        raise AssertionError(f"sharded encode: {launches} launches for {groups} "
                             f"groups (two calls), or not deterministic: {what}")
    err = (got.double() - exact).abs()
    ratio = float((err / tol).max())
    if not ratio <= 1.0 or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"sharded encode disagrees: {what} max err "
                             f"{float(err.max())}, {ratio} of its tolerance")
    s.enc_ratio = max(s.enc_ratio, ratio)
    s._record("encode", family, float(err.max()), False)


def _shard_kernel_checks(s: Smoke):
    """Kernels against plain over shard plans (the MLP tree; SmolLM-360M at
    full width, 2 layers)."""
    import dataclasses as dc

    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.core.tree import tree_leaves
    from repro_torch.models.api import Arch

    s.group = ("sharded, MLP tree (N=37): float32 and bf16, S = 1, 3, 8, all "
               "families at k = 1; FULL 8 and BLOCK 8 for all families at S = 3 "
               "(float32) and rademacher at S = 8 (bf16)")
    for dtype in (torch.float32, torch.bfloat16):
        params = {f"l{tag}": s.randn(r, c).to(dtype) for tag, (r, c) in enumerate(MLP)}
        for shards in SHARD_CHECK_COUNTS:
            for family in FAMILIES:
                _check_sharded(s, params, 37, family, 1, "full", shards,
                               f"mlp {dtype}")
        for mode in ("full", "block"):
            for shards, family in ([(3, f) for f in FAMILIES]
                                   if dtype == torch.float32 else [(8, "rademacher")]):
                _check_sharded(s, params, 37, family, 8, mode, shards,
                               f"mlp {dtype}")
    s.report()
    s.group = ("sharded, SmolLM-360M 2 layers (11 leaves, N=4): rademacher "
               "float32 and bf16 at S = 1, 3, 8; the other families bf16 at S = 8; "
               "FULL 8 bf16 at S = 3; BLOCK 8 float32 at S = 8 on the leaves "
               "under 2**24 elements")
    for dtype in ("float32", "bfloat16"):
        small = Arch(dc.replace(get_config(TRAIN_ARCH), num_layers=2, dtype=dtype)
                     ).init(seed=2, device=s.dev)
        for shards in SHARD_CHECK_COUNTS:
            _check_sharded(s, small, 4, "rademacher", 1, "full", shards,
                           f"smollm 2-layer {dtype}")
        if dtype == "bfloat16":
            for family in FAMILIES[1:]:
                _check_sharded(s, small, 4, family, 1, "full", 8,
                               f"smollm 2-layer {dtype}")
            _check_sharded(s, small, 4, "rademacher", 8, "full", 3,
                           f"smollm 2-layer {dtype}")
        else:
            under = {f"l{i:02d}": w for i, w in enumerate(tree_leaves(small))
                     if w.numel() <= 1 << 24}
            for family in ("rademacher", "hadamard"):
                _check_sharded(s, under, 4, family, 8, "block", 8,
                               f"smollm 2-layer {len(under)} leaves {dtype}")
        del small
        torch.cuda.empty_cache()
    s.report()


def _shard_resident(s: Smoke, launches):
    """SmolLM-360M's 11 bf16 leaves at full width: shard_tree +
    sharded_apply_blocks at S = 1, 2, 4, 8 against the unsharded decode
    (and fused close), bitwise; device ms per apply in turns; then the
    sharded encode at S = 8 against the unsharded tree encode."""
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.kernels import ops
    from repro_torch.kernels.seeded_projection import tree_encode_tolerance
    from repro_torch.launch.mesh import make_fed_mesh
    from repro_torch.models.api import Arch
    from repro_torch.sharding import fed_rules as fr

    counters = _kernel_fns()
    params = Arch(get_config(TRAIN_ARCH)).init(seed=1, device=s.dev)
    leaves = tree_leaves(params)
    d = sum(x.numel() for x in leaves)
    seeds, rs = s.seeds(SHARD_N), s.randn(SHARD_N, 1) * 0.3
    want = tree_leaves(ops.server_update_kernel(params, rs, seeds, 1.0))
    want_f = tree_leaves(ops.server_update_fused(params, rs, seeds, 1.0))
    fns = {"unsharded": lambda: ops.server_update_kernel(params, rs, seeds, 1.0)}
    rows = {}
    for shards in SHARD_COUNTS:
        mesh = make_fed_mesh((1, shards))
        plan = fr.plan_tree(params, shards)
        blocks = fr.shard_tree(params, plan, mesh)
        groups = _shard_groups(shards, len(leaves))
        got = {}
        for name, fused in (("rec", False), ("fused", True)):
            before = counters.read()[name]
            out = fr.sharded_apply_blocks(mesh, plan, blocks, rs, seeds, 1.0,
                                          use_fused=fused)
            n_launch = counters.read()[name] - before
            launches[name] += n_launch
            got[name] = tree_leaves(fr.from_sharded_2d(out, plan, params))
            if n_launch != groups:
                raise AssertionError(f"resident S={shards} {name}: {n_launch} "
                                     f"launches, expected {groups}")
            del out
        torch.cuda.synchronize()
        if not (all(torch.equal(g, w) for g, w in zip(got["rec"], want))
                and all(torch.equal(g, w) for g, w in zip(got["fused"], want_f))):
            raise AssertionError(f"resident S={shards}: not bitwise the unsharded "
                                 "decode / fused close")
        del got
        local = [(ls.per_shard, ls.layout.cols) if ls.axis == 0
                 else (ls.layout.rows, ls.per_shard) for ls in plan.leaves]
        bound, by = _rec_bound(local * shards, SHARD_N, 1, elem=2)
        rows[f"S={shards}"] = dict(
            shards=shards, launches_per_apply=groups,
            padded_elements=sum(r * c for r, c in local) * shards,
            bound_ms=bound, bound_by=by, device_ms=[])
        fns[f"S={shards}"] = (lambda mesh=mesh, plan=plan, blocks=blocks:
                              fr.sharded_apply_blocks(mesh, plan, blocks, rs, seeds,
                                                      1.0))
    bound, by = _rec_bound([(x.numel() // x.shape[-1], x.shape[-1]) for x in leaves],
                           SHARD_N, 1, elem=2)
    rows["unsharded"] = dict(shards=0, launches_per_apply=1, padded_elements=d,
                             bound_ms=bound, bound_by=by, device_ms=[])
    order = list(fns) + list(reversed(list(fns)))
    for name in order:                        # in turns, each twice
        rows[name]["device_ms"].append(_device_ms([fns[name]], reps=3))
    for name, fn in fns.items():
        rows[name]["enqueue_ms"] = _enqueue_ms(fn, reps=3)
        print(f"sharded resident loop: SmolLM-360M 11 bf16 leaves (d = {d}), "
              f"N = {SHARD_N}, k = 1: {name}: " + json.dumps(rows[name]), flush=True)
    base = min(rows["S=1"]["device_ms"])
    worst = max(min(rows[f"S={n}"]["device_ms"]) for n in SHARD_COUNTS)
    print(f"sharded resident loop: slowest S / S = 1: {worst / base!r}", flush=True)
    del want, want_f, fns
    # The sharded encode at full width (S = 8, k = 1) against the unsharded
    # tree encode: within the sum of the two encodes' tolerances.
    delta = tree_map(lambda w: (w.float() * 1e-2).to(torch.bfloat16), params)
    del params
    mesh = make_fed_mesh((1, 8))
    plan = fr.plan_tree(delta, 8)
    seed = s.seeds(1)
    before = counters.read()["encode"]
    got = fr.sharded_project_tree(mesh, delta, seed, plan=plan)
    n_launch = counters.read()["encode"] - before
    launches["encode"] += n_launch
    flat = ops.project_tree_kernel(tree_map(lambda v: v[None], delta), seed)[0]
    views = [x[None] for ls, v in zip(plan.leaves, fr.to_sharded_2d(delta, plan))
             for x in fr._split(v, ls, mesh)]
    tol = float((tree_encode_tolerance(views, "rademacher")[0]
                 + tree_encode_tolerance([x.reshape(1, -1, x.shape[-1])
                                          for x in tree_leaves(delta)],
                                         "rademacher")[0]).max())
    torch.cuda.synchronize()
    err = float((got.double() - flat.double()).abs().max())
    if n_launch != 2 * _shard_groups(8, len(leaves)) or not err <= tol:
        raise AssertionError(f"sharded encode at full width: {n_launch} launches, "
                             f"|sharded - unsharded| {err} over {tol}")
    print(f"sharded encode: SmolLM-360M 11 bf16 leaves, S = 8: {n_launch} launches, "
          f"|sharded - unsharded| {err!r} (limit {tol!r})", flush=True)
    del delta, views
    torch.cuda.empty_cache()
    return rows


def _shard_reference_shape(s: Smoke):
    """benchmarks/run.py's sharding sweep: d = 2**18, 2**20 as (512, d/512)
    float32, cohorts 64 and 256, S = 1, 2, 4, 8, resident, bitwise against
    the unsharded decode; device ms per apply."""
    import torch

    from repro_torch.core import fedscalar as tfs
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_fed_mesh
    from repro_torch.sharding import fed_rules as fr

    rows = []
    for d in SHARD_REF_DIMS:
        params = {"w": s.randn(SHARD_REF_ROWS, d // SHARD_REF_ROWS)}
        for cohort in SHARD_REF_COHORTS:
            seeds = tfs.round_seeds(0, cohort, device=s.dev)
            rs = s.randn(cohort, 1)
            want = ops.server_update_kernel(params, rs, seeds)["w"]
            for shards in SHARD_COUNTS:
                mesh = make_fed_mesh((1, shards))
                plan = fr.plan_tree(params, shards)
                blocks = fr.shard_tree(params, plan, mesh)

                def apply(mesh=mesh, plan=plan, blocks=blocks):
                    return fr.sharded_apply_blocks(mesh, plan, blocks, rs, seeds)

                got = fr.from_sharded_2d(apply(), plan, params)["w"]
                if not torch.equal(got, want):
                    raise AssertionError(f"sharding shape d={d} N={cohort} "
                                         f"S={shards}: not bitwise the unsharded "
                                         "decode")
                ms = _device_ms([apply], reps=20)
                ls = plan.leaves[0]
                bound, by = _rec_bound([(ls.per_shard, ls.layout.cols)] * shards,
                                       cohort, 1)
                row = dict(d=d, cohort=cohort, shards=shards, device_ms=ms,
                           enqueue_ms=_enqueue_ms(apply),
                           elements_per_s=d * cohort / (ms / 1e3),
                           bound_ms=bound, bound_by=by)
                rows.append(row)
                print("sharded reference shape: " + json.dumps(row), flush=True)
    return rows


def _shard_runtime(s: Smoke, launches):
    """run_federation at examples/runtime_scale.py's population under
    mesh_shape=(2, 4) (digest downlink, shadow replay) against the same run
    without it on the decode route; then 3 rounds of sync and async."""
    import numpy as np
    import torch

    from repro_torch.data import load_digits, make_client_datasets
    from repro_torch.data import train_test_split_arrays
    from repro_torch.fed.runtime import RuntimeConfig, run_federation
    from repro_torch.models.mlp_classifier import init_mlp
    from repro_torch.sharding import fed_rules as fr

    x, y = load_digits()
    xtr, ytr, xte, yte = train_test_split_arrays(x, y)
    clients = make_client_datasets(xtr, ytr, RT_SHARDS)
    counters = _kernel_fns()
    per_call = []
    apply_blocks = fr.sharded_apply_blocks

    def counted(*args, **kwargs):
        before = counters.read()
        out = apply_blocks(*args, **kwargs)
        torch.cuda.synchronize()
        per_call.append({k: n - before[k] for k, n in counters.read().items()})
        return out

    def run(cfg, mesh):
        counters.reset()
        fr.sharded_apply_blocks = counted if mesh else apply_blocks
        try:
            t0 = time.perf_counter()
            h = run_federation(cfg, init_mlp(seed=0, device="cuda"), clients, xte,
                               yte, device="cuda")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            fr.sharded_apply_blocks = apply_blocks
        got = counters.read()
        if mesh:
            for k in launches:
                launches[k] += got[k]
        return h, {k: got[k] for k in launches}, wall

    def same(ha, hb):
        return (all(torch.equal(ha["final_params"][k], hb["final_params"][k])
                    for k in ha["final_params"])
                and all(np.array_equal(ha[k], hb[k]) for k in
                        ("cohort_size", "applied", "cum_bits", "cum_downlink_bits")))

    rows = {}
    base = dict(rounds=RT_ROUNDS, population=RT_POPULATION,
                participation=RT_PARTICIPATION, eval_every=1, seed=0,
                downlink_mode="digest", verify_replay=True)
    h_mesh, got, wall = run(RuntimeConfig(mesh_shape=MESH_SHAPE, **base), True)
    h_rec, _, wall_rec = run(RuntimeConfig(**base), False)
    applied = int((h_mesh["applied"] > 0).sum())
    entries = 8 * len(init_mlp(seed=0, device="cuda"))
    if not same(h_mesh, h_rec):
        raise AssertionError("mesh run: not bitwise the decode-route run")
    one_decode = [{"encode": 0, "fused": 0, "rec": 1, "qsgd": 0}] * applied
    if (per_call != one_decode or got["rec"] != 2 * applied or got["fused"] != 0
            or h_mesh["sharding"]["devices"] != 8 or entries > 64):
        raise AssertionError(f"mesh run: launches {got}, per apply "
                             f"{per_call[:3]}..., sharding {h_mesh['sharding']}")
    loss = h_mesh["loss"]
    if not np.isfinite(loss).all() or not loss[-1] < loss[0]:
        raise AssertionError(f"mesh run: loss did not fall: {loss[0]} -> {loss[-1]}")
    applied_s = h_mesh["apply_s"] > 0
    rows["mesh_digest_replay"] = dict(
        rounds_per_s=RT_ROUNDS / wall, rounds_per_s_without_mesh=RT_ROUNDS / wall_rec,
        median_apply_ms=float(np.median(h_mesh["apply_s"][applied_s]) * 1e3),
        median_apply_ms_without_mesh=float(
            np.median(h_rec["apply_s"][h_rec["apply_s"] > 0]) * 1e3),
        launches=got, decode_launches_per_mesh_apply=1, entries_per_launch=entries,
        sharding=h_mesh["sharding"], loss_first=float(loss[0]),
        loss_last=float(loss[-1]), replay_verified=True)
    print("sharded runtime: mesh_shape=(2, 4), digest + shadow replay, bitwise "
          "the decode-route run: " + json.dumps(rows["mesh_digest_replay"]),
          flush=True)
    for name, sched in (("sync", dict(mode="sync")), ("async", SCHED_ASYNC)):
        per_call.clear()
        hm, got, wall = run(_sched_config(dict(mesh_shape=MESH_SHAPE), sched,
                                          MESH_SCHED_ROUNDS), True)
        hr, _, _ = run(_sched_config({}, sched, MESH_SCHED_ROUNDS), False)
        applied = int((hm["applied"] > 0).sum())
        if not same(hm, hr) or per_call != [one_decode[0]] * applied:
            raise AssertionError(f"mesh {name}: not bitwise its decode-route run, "
                                 f"or launches per apply {per_call}")
        rows[f"mesh_{name}"] = dict(host_s_per_round=wall / MESH_SCHED_ROUNDS,
                                    launches=got, applied_rounds=applied)
        print(f"sharded runtime: {name} scheduler, mesh_shape=(2, 4), "
              f"{MESH_SCHED_ROUNDS} rounds, bitwise its decode-route run: "
              + json.dumps(rows[f"mesh_{name}"]), flush=True)
    return rows


def phase_sharded(s: Smoke):
    """Phase 16: the mesh-sharded server on the card → (launches, rows)."""
    t0 = time.perf_counter()
    n0 = s.checks
    _shard_kernel_checks(s)
    launches = {"encode": 0, "fused": 0, "rec": 0}
    rows = {"resident": _shard_resident(s, launches)}
    rows["reference_shape"] = _shard_reference_shape(s)
    rows["runtime"] = _shard_runtime(s, launches)
    print(f"sharded: all {s.checks - n0} kernel checks ok, main-path launches "
          f"{launches}, in {time.perf_counter() - t0:.1f} s", flush=True)
    return launches, rows


# ---------------------------------------------------------------------------
# Phase 18: the VLM and enc-dec families (PaliGemma-3B, Whisper-tiny)
# ---------------------------------------------------------------------------

VLM_ARCH, ENCDEC_ARCH = "paligemma-3b", "whisper-tiny"
# PaliGemma's head shape at reduced width: 2 heads over 1 kv head of 256.
VLM_HD256 = dict(d_model=512, num_heads=2, num_kv_heads=1, head_dim=256)
# Full width, bf16: PaliGemma at batch 1, its 256 patch embeddings + 8192
# text tokens; Whisper at batch 4, (4, 1500, 384) frames and a decoder
# prompt of 8448 tokens (learned positions taken mod 4096).  Both into a
# cache of 16 384 slots, then SERVE_GEN greedy steps.
VLM_BATCH, VLM_PROMPT = 1, 256 + 8192
ENCDEC_BATCH, ENCDEC_PROMPT = 4, 8448
FAMILY_CAPACITY = 16384
# One FedScalar round of each at full width, bf16 (rademacher, k = 1,
# N = 2, S = 1, one sequence a client): decoder positions per sequence.
FAMILY_TRAIN = ((VLM_ARCH, 256 + 1792), (ENCDEC_ARCH, 448))
FAMILY_TRAIN_CLIENTS = 2
# The serve-consistency property on the card (reduced Whisper, float32):
# prefill and decode logits against the full decoder forward, atol/rtol
# 1e-4, the reference's own tolerance in test_whisper_serve_consistency.
CONSISTENCY_TOL = 1e-4


def phase_flash_hd256(s: Smoke):
    """Flash attention at head_dim 256 on all three routes against the plain
    version, and Whisper's decoder prefill shape (hd 64, G = 1); then each
    timed at its main-path shape beside its bound and SDPA.  → the rows."""
    import torch

    t0 = time.perf_counter()
    n0 = s.checks
    s.group = ("flash attention at head_dim 256 (PaliGemma's 8 heads over 1): ragged "
               "S = T = 333 and S = 200 against T = 1000, kpos -1 holes with padding "
               "queries, causal and window 64; a wrapped ring of 1000 (S = 1 and 300, "
               "windows 0, 64, 1000); decode over 16384 slots")
    ring = torch.full((1000,), -1, dtype=torch.int64)
    written = torch.arange(500, 1500)
    ring[written % 1000] = written
    filled = FAMILY_CAPACITY - 16
    dec_kpos = torch.where(torch.arange(FAMILY_CAPACITY) < filled,
                           torch.arange(FAMILY_CAPACITY), -1)
    for dtype in (torch.bfloat16, torch.float32):
        for window in (0, 64):
            s.check_flash(2, 333, 333, 8, 1, 256, dtype, window)
            s.check_flash(1, 200, 1000, 8, 1, 256, dtype, window)
            kpos = torch.arange(333)
            kpos[::5] = -1
            qpos = torch.arange(333)
            qpos[:40] = -1
            s.check_flash(1, 333, 333, 8, 1, 256, dtype, window, qpos, kpos)
        for window in (0, 64, 1000):
            s.check_flash(1, 1, 1000, 8, 1, 256, dtype, window, torch.tensor([1499]), ring)
            s.check_flash(1, 300, 1000, 8, 1, 256, dtype, window,
                          torch.arange(1200, 1500), ring)
        s.check_flash(1, 1, FAMILY_CAPACITY, 8, 1, 256, dtype,
                      qpos=torch.tensor([filled - 1]), kpos=dec_kpos)
    s.report()
    s.group = ("flash attention at phase 18's full shapes: the bf16 prefill at hd 256 "
               f"(B 1, S = T = {FAMILY_CAPACITY}, 8/1), the float32 kernel at hd 256 "
               f"(S = T = {PARITY_PROMPT}), Whisper's decoder prefill (B "
               f"{ENCDEC_BATCH}, S = T = {ENCDEC_PROMPT}, 6/6, hd 64)")
    s.check_flash(1, FAMILY_CAPACITY, FAMILY_CAPACITY, 8, 1, 256, torch.bfloat16)
    torch.cuda.empty_cache()
    s.check_flash(1, PARITY_PROMPT, PARITY_PROMPT, 8, 1, 256, torch.float32)
    torch.cuda.empty_cache()
    s.check_flash(ENCDEC_BATCH, ENCDEC_PROMPT, ENCDEC_PROMPT, 6, 6, 64, torch.bfloat16)
    torch.cuda.empty_cache()
    s.report()
    print(f"flash hd 256: all {s.checks - n0} checks ok in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    i32 = dict(dtype=torch.int32, device=s.dev)

    def ar(n):
        return torch.arange(n, **i32)

    dec_q = torch.tensor([filled - 1], **i32)
    dec_k = torch.where(ar(FAMILY_CAPACITY) < filled, ar(FAMILY_CAPACITY), -1)
    shapes = {   # name -> (route, B, S, T, H, K, hd, dtype, qpos, kpos)
        "prefill_hd256": ("prefill", 1, FAMILY_CAPACITY, FAMILY_CAPACITY, 8, 1, 256,
                          torch.bfloat16, ar(FAMILY_CAPACITY), ar(FAMILY_CAPACITY)),
        "decode_hd256": ("decode", 1, 1, FAMILY_CAPACITY, 8, 1, 256, torch.bfloat16,
                         dec_q, dec_k),
        "decode_hd256_f32": ("decode", 1, 1, FAMILY_CAPACITY, 8, 1, 256, torch.float32,
                             dec_q, dec_k),
        "f32_hd256": ("f32", 1, PARITY_PROMPT, PARITY_PROMPT, 8, 1, 256, torch.float32,
                      ar(PARITY_PROMPT), ar(PARITY_PROMPT)),
        "prefill_whisper": ("prefill", ENCDEC_BATCH, ENCDEC_PROMPT, ENCDEC_PROMPT, 6, 6,
                            64, torch.bfloat16, ar(ENCDEC_PROMPT), ar(ENCDEC_PROMPT)),
    }
    rows = {}
    for name, (route, *shape) in shapes.items():
        rows[name] = _flash_time_row(s, route, *shape)
        print(f"flash times ({name}): " + json.dumps(rows[name]), flush=True)
    return rows


def _consistency(s: Smoke):
    """Reduced Whisper, float32, on the card: the reference's
    ``test_whisper_serve_consistency`` at phase 9's prompt (8448 tokens,
    over the 8192 threshold: the float32 kernel in the prefill and the full
    forward, the split-KV decode at the step) — prefill and one decode
    step give the full decoder forward's logits at S − 1 and S."""
    import torch

    import repro_torch.models.encdec as ed
    from repro_torch.configs.registry import get_config

    cfg = get_config(ENCDEC_ARCH).reduced()
    gen = torch.Generator(device=s.dev).manual_seed(5)
    p = ed.init_encdec(cfg, gen)
    inputs = _frontend(cfg, 1, PARITY_PROMPT + 1, gen=gen, device=s.dev)
    frames, tokens = inputs["embeds"], inputs["tokens"]
    n = PARITY_PROMPT
    enc = ed.encode(p, cfg, frames)
    pos = torch.arange(n + 1, dtype=torch.int32, device=s.dev)
    x = ed._dec_embed(p, cfg, tokens, pos)
    for i in range(cfg.num_layers):
        x, _ = ed._dec_sublayer(ed.stack_slice(p["dec_layers"], i), x, cfg, enc, pos)
    full = ed._logits(p, ed.apply_norm(p["dec_norm"], x, cfg.norm))
    lp, caches = ed.encdec_prefill(p, cfg, frames, tokens[:, :n], capacity=PARITY_CAPACITY)
    lg, caches = ed.encdec_decode(p, cfg, tokens[:, n:n + 1], caches, n)
    torch.cuda.synchronize()
    errs = [float((lp[:, 0] - full[:, n - 1]).abs().max()),
            float((lg[:, 0] - full[:, n]).abs().max())]
    limits = [CONSISTENCY_TOL * (1 + float(full[:, j].abs().max())) for j in (n - 1, n)]
    if not all(e <= lim for e, lim in zip(errs, limits)):
        raise AssertionError(f"whisper serve consistency: prefill / decode logits "
                             f"{errs} from the full forward (limits {limits})")
    return dict(prompt=n, prefill_max_abs_dlogits=errs[0],
                decode_max_abs_dlogits=errs[1], limits=limits)


def phase_vlm_encdec_parity(s: Smoke):
    """Card against CPU, float32, phase 9's prompt and cache: reduced
    PaliGemma (hd 64) and its head_dim-256 variant (16 patch embeddings +
    8432 tokens; the prefill with the prefix runs the plain recurrence,
    each decode step past the prefix the split-KV kernel), reduced Whisper
    (64 frames + 8448 tokens: the float32 kernel at prefill); then the
    serve-consistency property of reduced Whisper on the card.
    → flash launches."""
    from repro_torch.configs.registry import get_config

    total = dict.fromkeys(_flash_counters(), 0)
    vlm = get_config(VLM_ARCH).reduced()
    cases = ((vlm, False), (dataclasses.replace(vlm, **VLM_HD256), False),
             (get_config(ENCDEC_ARCH).reduced(), True))
    for cfg, prefill_kernel in cases:
        t0 = time.perf_counter()
        par = _card_vs_cpu(s, cfg, prefill_kernel=prefill_kernel)
        print("vlm/enc-dec parity: " + json.dumps(dict(
            arch=cfg.name, layers=cfg.num_layers, heads=cfg.num_heads,
            kv_heads=cfg.num_kv_heads, head_dim=cfg.resolved_head_dim,
            prefix=cfg.prefix_bidirectional, prompt_positions=PARITY_PROMPT,
            decode_steps=PARITY_GEN, max_abs_dlogits=par["err"],
            logits_scale=float(par["cpu"].abs().max()), max_abs_dcache=par["cache_err"],
            tolerance=PARITY_ATOL, flash_launches=par["launches"],
            s=time.perf_counter() - t0)), flush=True)
        for k in total:
            total[k] += par["launches"][k]
    t0 = time.perf_counter()
    flash = _flash_counters()
    row = _consistency(s)
    print("whisper serve consistency (card, float32): " + json.dumps(dict(
        row, tolerance=CONSISTENCY_TOL,
        flash_launches=flash.read(),
        s=time.perf_counter() - t0)), flush=True)
    return total


def phase_vlm_encdec_serve(s: Smoke, flash_rows):
    """PaliGemma-3B (batch 1, 256 embeddings + 8192 tokens) and Whisper-tiny
    (batch 4, 1500 frames + 8448 tokens) at full width, bf16, through the
    serve steps into 16 384 slots, 32 greedy steps; then flash on the
    first attention layer's own q, k, v of Whisper's prefill and of each
    one's first decode step.  → flash launches."""
    import torch

    import repro_torch.models.attention as attention
    from repro_torch.configs.registry import get_config

    total = dict.fromkeys(_flash_counters(), 0)
    captured = []
    for name, batch, prompt in ((VLM_ARCH, VLM_BATCH, VLM_PROMPT),
                                (ENCDEC_ARCH, ENCDEC_BATCH, ENCDEC_PROMPT)):
        t0 = time.perf_counter()
        cfg = get_config(name)
        blocked = attention._sdpa_blocked

        def capture(q, k, v, qpos, kpos, *, causal, window, prefix_len):
            step = "prefill" if q.shape[1] > 1 else "decode"
            if (name, step) not in [c[:2] for c in captured]:
                captured.append((name, step, *(t.clone() for t in (q, k, v, qpos, kpos)),
                                 window))
            return blocked(q, k, v, qpos, kpos, causal=causal, window=window,
                           prefix_len=prefix_len)

        @contextlib.contextmanager
        def hooks():
            attention._sdpa_blocked = capture
            try:
                yield
            finally:
                attention._sdpa_blocked = blocked

        vlm = cfg.frontend == "vision"
        row, launches, params = _serve_run(s, cfg, batch, hooks, prompt=prompt,
                                           capacity=FAMILY_CAPACITY,
                                           prefill_kernel=not vlm)
        key = "decode_hd256" if vlm else "prefill_whisper"
        row.update(flash_shape=flash_rows[key]["shape"],
                   flash_ms_per_layer=flash_rows[key]["ms"], s=time.perf_counter() - t0)
        print("vlm/enc-dec serve: " + json.dumps(row), flush=True)
        for k in total:
            total[k] += launches[k]
        del params
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    s.group = ("flash attention at phase 18's shapes: the first attention layer's "
               "q, k, v of Whisper's full-width prefill and of each first decode step")
    # PaliGemma's prefill (a query inside the prefix) takes the plain
    # recurrence, so it launches no kernel and is not captured as one.
    want = [(VLM_ARCH, "prefill"), (VLM_ARCH, "decode"), (ENCDEC_ARCH, "prefill"),
            (ENCDEC_ARCH, "decode")]
    if [c[:2] for c in captured] != want:
        raise AssertionError(f"vlm/enc-dec serve: captured "
                             f"{[c[:2] for c in captured]}, expected {want}")
    for name, step, q, k, v, qpos, kpos, window in captured:
        if (name, step) != (VLM_ARCH, "prefill"):
            s.check_flash_on(q, k, v, qpos.to(torch.int32), kpos.to(torch.int32), window)
    s.report()
    del captured
    torch.cuda.empty_cache()
    print(f"vlm/enc-dec flash check: {time.perf_counter() - t0:.1f} s", flush=True)
    return total


def phase_vlm_encdec_train(s: Smoke):
    """One FedScalar round of PaliGemma-3B and of Whisper-tiny at full width,
    bf16, through ``launch/train.py`` (rademacher, k = 1, N = 2, S = 1):
    each client's r against the plain encode of its own δ (summed in
    float64) within ``tree_encode_tolerance``, the close bitwise the port's
    ``server_aggregate`` and its plain version (as phase 13)."""
    import torch

    import repro_torch.kernels.ops as ops
    from repro_torch.configs.registry import get_config
    from repro_torch.core.projection import leaf_layout
    from repro_torch.core.tree import tree_leaves
    from repro_torch.kernels.seeded_projection import (
        project_tree_plain,
        tree_encode_tolerance,
    )
    from repro_torch.kernels.tree import tree_plan
    from repro_torch.launch.train import FLRunConfig, make_train_step
    from repro_torch.models.api import Arch

    encode = ops.project_tree_kernel
    worst, check_s = [0.0], [0.0]

    def checked(deltas, seeds, distribution, k, mode):
        r = encode(deltas, seeds, distribution, k, mode)
        torch.cuda.synchronize()
        t_check = time.perf_counter()
        leaves = tree_leaves(deltas)
        plan = tree_plan("encode", [tuple(x.shape[1:]) for x in leaves],
                         [x.dtype for x in leaves], k, mode, s.dev)
        want = project_tree_plain(leaves, seeds, plan, "rademacher", dtype=torch.float64)
        views = [x.reshape(1, ll.rows, ll.cols) for ll, x in zip(plan.layout, leaves)]
        ratio = float(((r.double() - want).abs()
                       / tree_encode_tolerance(views, "rademacher")).max())
        if not ratio <= 1.0:
            raise AssertionError(f"family train: r {r.tolist()} against the plain "
                                 f"encode {want.tolist()}: {ratio} of the tolerance")
        worst[0] = max(worst[0], ratio)
        del want
        torch.cuda.synchronize()
        check_s[0] += time.perf_counter() - t_check
        return r

    n = FAMILY_TRAIN_CLIENTS
    counters = _train_counters()
    for name, positions in FAMILY_TRAIN:
        t0 = time.perf_counter()
        cfg = get_config(name)
        arch = Arch(cfg)
        params = arch.init(seed=0, device=s.dev)
        layout = leaf_layout(params)
        batch = _frontend(cfg, n, positions + 1, gen=s.gen, device=s.dev)
        toks = batch.pop("tokens")
        batch.update(tokens=toks[:, :-1], labels=toks[:, 1:])
        step = make_train_step(arch, FLRunConfig(num_virtual_clients=n, local_steps=1,
                                                 local_lr=TRAIN_LR, server_lr=1.0))
        counters.reset()
        worst[0], check_s[0] = 0.0, 0.0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.project_tree_kernel = checked
        try:
            t1 = time.perf_counter()
            new, m = step(params, batch, 0)
            torch.cuda.synchronize()
            # the round without the plain encodes of the check
            round_s = time.perf_counter() - t1 - check_s[0]
        finally:
            ops.project_tree_kernel = encode
        launches = counters.moved()
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        if launches != {"encode": 2 * n, "rec": 1}:
            raise AssertionError(f"family train {name}: launches {launches}, expected "
                                 f"{{'encode': {2 * n}, 'rec': 1}}")
        close = _train_close_check(s, params, new, m, layout)
        if not (math.isfinite(float(m["loss"])) and m["uploaded_scalars"] == 2 * n
                and all(w.dtype == torch.bfloat16 for w in tree_leaves(new))):
            raise AssertionError(f"family train {name}: loss {float(m['loss'])}, "
                                 f"uploads {m['uploaded_scalars']}")
        print("vlm/enc-dec train: " + json.dumps(dict(
            arch=name, layers=cfg.num_layers, dtype=cfg.dtype, clients=n, local_steps=1,
            positions_per_client=positions,
            frontend_embeds=batch["embeds"].shape[1] if "embeds" in batch else 0,
            params=sum(ll.size for ll in layout), leaves=len(layout),
            round_s=round_s, check_s=check_s[0],
            train_positions_per_s=n * positions / round_s,
            loss=float(m["loss"]), r=m["r"].flatten().tolist(),
            r_max_err_over_tolerance=worst[0], close=close, launches=launches,
            peak_gib=peak_gib, s=time.perf_counter() - t0)), flush=True)
        del params, new, m, batch
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 19: leaves past 2³¹ elements, the meta dry run against the card, the
# client-parallel train step
# ---------------------------------------------------------------------------

# Falcon-Mamba-7B's stacked in_proj, (64 · 4096, 16 384) bf16: 2³² elements
BIG_LEAF = (64 * 4096, 16384)
BIG_CLIENTS = 4
BIG_SLAB_ROWS = 4096                  # the plain versions' row ranges (2²⁶ elements)
DRYRUN_WORKERS = 4                    # the meta sweep's processes (of the 8 cores)
META_TOL = 0.15                       # |card peak − meta estimate| / meta estimate
META_RUN_SHARE = 0.9                  # run a step only under this share of memory
MINITRON = "minitron-8b"
CP_LOSS_RTOL = 0.01                   # client-parallel vs sequential, bf16
CP_R_SIGMAS = 6.0                     # |Δr| in standard deviations ‖Δδ‖₂ of ⟨Δδ, v⟩


def start_dryrun_sweep(torch):
    """The dry run over all ten configs × four shapes (``--fit``), on ``meta``
    in worker processes at low priority, started when phase 19 begins (the
    timings of phases 1–18 run without it); ``phase_dryrun`` waits for it
    at the phase's end.  → (process, its record directory)."""
    import os

    out = REPO / "chiprun_out" / "dryrun_torch"
    out.mkdir(parents=True, exist_ok=True)
    capacity = torch.cuda.get_device_properties(0).total_memory
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--all", "--fit",
           "--workers", str(DRYRUN_WORKERS), "--capacity-bytes", str(capacity),
           "--outdir", str(out)]
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    log = open(out / "sweep.log", "w")
    # its own session, so that its worker processes can be stopped with it
    proc = subprocess.Popen(cmd, env=env, stdout=log, stderr=subprocess.STDOUT,
                            cwd=str(REPO), start_new_session=True,
                            preexec_fn=lambda: os.nice(10))
    proc.log = log
    return proc, out


def phase_big_leaf(s: Smoke):
    """Falcon-Mamba-7B's in_proj, 2³² bf16 elements (8 GiB), through the three
    FedScalar tree kernels: the encode (N = 1) within ``encode_tolerance`` of
    its plain float64 sum, the per-client decode (N = 4, per-client
    rounding) and the fused close (N = 4) bitwise their plain versions over
    row ranges of the leaf; each timed beside its bound and its plain time."""
    import torch

    from repro_torch.core.prng import U32_MASK
    from repro_torch.kernels import ops
    from repro_torch.kernels.reconstruct_apply import fused_apply_plain, pad_cohort
    from repro_torch.kernels.seeded_projection import (
        encode_tolerance,
        project_blocks_plain,
    )
    from repro_torch.kernels.seeded_reconstruct import reconstruct_plain

    t0 = time.perf_counter()
    rows, cols = BIG_LEAF
    n = BIG_CLIENTS
    x = torch.empty(BIG_LEAF, dtype=torch.bfloat16, device=s.dev)
    for r0 in range(0, rows, BIG_SLAB_ROWS):
        x[r0:r0 + BIG_SLAB_ROWS] = torch.randn((BIG_SLAB_ROWS, cols), generator=s.gen,
                                               device=s.dev)
    seeds, rs = s.seeds(n), s.randn(n, 1) * 0.3
    fns = _kernel_fns()
    fns.reset()
    r = ops.project_tree_kernel({"w": x[None]}, seeds[:1])
    y_rec = ops.server_update_kernel({"w": x}, rs, seeds, per_client_rounding=True)["w"]
    torch.cuda.synchronize()
    launches = fns.moved()
    if launches != {"encode": 2, "rec": 1}:
        raise AssertionError(f"big leaf: launches {launches}")

    t1 = time.perf_counter()
    exact = project_blocks_plain(x[None], seeds[:1], 0, torch.zeros(1, device=s.dev),
                                 torch.full((1,), 2.0 ** 40, device=s.dev),
                                 dtype=torch.float64)
    torch.cuda.synchronize()
    enc_plain_ms = (time.perf_counter() - t1) * 1e3
    enc_err = float((r.double() - exact).abs().max())
    enc_tol = float(encode_tolerance(x[None], "rademacher").max())
    if not enc_err <= enc_tol:
        raise AssertionError(f"big leaf: encode off by {enc_err} (tolerance {enc_tol})")

    def slabs(y, plain):
        t = time.perf_counter()
        for r0 in range(0, rows, BIG_SLAB_ROWS):
            want = plain(r0)
            if not torch.equal(y[r0:r0 + BIG_SLAB_ROWS], want):
                raise AssertionError(f"big leaf: rows {r0}.. differ from the plain "
                                     "version")
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3

    rec_plain_ms = slabs(y_rec, lambda r0: reconstruct_plain(
        x[r0:r0 + BIG_SLAB_ROWS], seeds, rs, 0, 1.0, None, None, row_offset=r0,
        orig_cols=cols, per_client_rounding=True, div=float(n)))
    del y_rec
    fns.reset()
    y_fused = ops.server_update_fused({"w": x}, rs, seeds)["w"]
    torch.cuda.synchronize()
    launches["fused"] = fns.read()["fused"]
    if launches["fused"] != 1:
        raise AssertionError(f"big leaf: fused launches {launches['fused']}")
    seeds_p, rs_p = pad_cohort(seeds & U32_MASK,
                               rs * torch.tensor(1.0 / n, dtype=torch.float32,
                                                 device=s.dev))
    zero = torch.zeros(1, device=s.dev)
    fused_plain_ms = slabs(y_fused, lambda r0: fused_apply_plain(
        x[r0:r0 + BIG_SLAB_ROWS], seeds_p, rs_p, 0, zero, zero, row_offset=r0,
        orig_cols=cols))
    del y_fused
    s.errs["encode"] = max(s.errs["encode"], enc_err)

    shapes = [BIG_LEAF]
    enc_ms = s.time_ms(lambda: ops.project_tree_kernel({"w": x[None]}, seeds[:1]),
                       reps=3, warmup=1)
    rec_ms = s.time_ms(lambda: ops.server_update_kernel(
        {"w": x}, rs, seeds, per_client_rounding=True), reps=3, warmup=1)
    fused_ms = s.time_ms(lambda: ops.server_update_fused({"w": x}, rs, seeds),
                         reps=3, warmup=1)
    rows_out = {}
    for kernel, ms, plain_ms, (bound, by) in (
            ("encode", enc_ms, enc_plain_ms, _encode_bound(shapes, 1, 1, elem=2)),
            ("rec", rec_ms, rec_plain_ms, _rec_bound(shapes, n, 1, elem=2)),
            ("fused", fused_ms, fused_plain_ms, _fused_bound(shapes, n, 1, elem=2))):
        rows_out[kernel] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by)
        print("big leaf: " + json.dumps(dict(
            kernel=kernel, leaf=list(BIG_LEAF), elements=rows * cols, dtype="bfloat16",
            clients=1 if kernel == "encode" else n, ms=ms, bound_ms=bound,
            bound_by=by, over_bound=ms / bound, plain_ms=plain_ms)), flush=True)
    del exact
    launches["qsgd"] = _big_leaf_qsgd(s, x)
    print("big leaf: " + json.dumps(dict(
        encode_abs_err=enc_err, encode_tolerance=enc_tol, decode_bitwise=True,
        fused_bitwise=True, qsgd_bitwise=True, launches=launches,
        peak_gib=torch.cuda.max_memory_allocated() / 2**30,
        s=time.perf_counter() - t0)), flush=True)
    del x
    torch.cuda.empty_cache()
    return launches


def _big_leaf_qsgd(s: Smoke, x):
    """QSGD past 2³¹ (phase 19): ``qsgd_tree`` (8 bits, N = 1) on the 2³²
    leaf ``x``, then on a two-leaf tree whose second leaf (8 × 8, float32)
    starts at payload column 2³¹ (the first is ``x``'s first 2³¹ elements):
    q and the payload bitwise ``qsgd_quantize_plain`` over row ranges given
    the kernel's norms, each norm within h·2⁻²⁴·‖x‖₂ (``norm_tolerance``,
    the float64 norm summed over the same ranges); the 2³² leaf's call timed
    beside its bound.  → the QSGD launches of the two checked calls."""
    import torch

    from repro_torch.kernels.common import fold_seed
    from repro_torch.kernels.qsgd_quant import (
        norm_depth,
        qsgd_quantize_plain,
        qsgd_tree,
    )

    rows, cols = BIG_LEAF
    levels = 127
    seeds = s.seeds(1)
    launches = 0

    def check(leaves, what):
        nonlocal launches
        before = _totals()["qsgd.launches"]
        q, pay, norms = qsgd_tree(leaves, seeds, levels, want_q=True,
                                  want_levels=True)
        torch.cuda.synchronize()
        launches += _totals()["qsgd.launches"] - before
        if _totals()["qsgd.launches"] - before != 2:
            raise AssertionError(f"qsgd past 2^31 ({what}): "
                                 f"{_totals()['qsgd.launches'] - before} launches")
        t = time.perf_counter()
        offset, worst = 0, 0.0
        for tag, leaf in enumerate(leaves):
            n_rows, n_cols = leaf.shape[1:]
            folded, nm = fold_seed(seeds, tag), norms[:, tag].contiguous()
            sq = 0.0
            for r0 in range(0, n_rows, BIG_SLAB_ROWS):
                r1 = min(r0 + BIG_SLAB_ROWS, n_rows)
                qp, lp = qsgd_quantize_plain(leaf[:, r0:r1], folded, nm, levels,
                                             True, True, row_offset=r0)
                got_lv = pay[:, offset + r0 * n_cols:offset + r1 * n_cols]
                if not (torch.equal(q[tag][:, r0:r1], qp)
                        and torch.equal(got_lv, lp.reshape(1, -1))):
                    raise AssertionError(f"qsgd past 2^31 ({what}): leaf {tag} "
                                         f"rows {r0}.. differ from the plain version")
                sq += float(leaf[:, r0:r1].double().pow(2).sum())
            exact = math.sqrt(sq)
            err = abs(float(nm[0]) - exact)
            tol = norm_depth(n_rows * n_cols) * 2.0 ** -24 * exact
            if not err <= tol:
                raise AssertionError(f"qsgd past 2^31 ({what}): leaf {tag} norm off "
                                     f"by {err} (tolerance {tol})")
            worst = max(worst, err / tol)
            s.norm_ratio = max(s.norm_ratio, err / tol)
            offset += n_rows * n_cols
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t) * 1e3
        print("big leaf: qsgd " + json.dumps(dict(
            tree=what, payload_columns=offset + len(leaves),
            second_leaf_offset=leaves[0][0].numel() if len(leaves) > 1 else None,
            bitwise=True, norm_err_over_tolerance=worst, plain_ms=plain_ms)),
            flush=True)
        return plain_ms

    plain_ms = check([x[None]], "the 2^32 leaf")
    # The call, and the quantize pass alone (the norms given): their
    # difference is the norm pass, whose spans are capped at
    # QSGD_NORM_UNITS_MAX a (client, leaf).
    norms = qsgd_tree([x[None]], seeds, levels, want_q=False, want_levels=True)[2]
    ms = s.time_ms(lambda: qsgd_tree([x[None]], seeds, levels, want_q=True,
                                     want_levels=True), reps=3, warmup=1)
    quant_ms = s.time_ms(lambda: qsgd_tree([x[None]], seeds, levels, want_q=True,
                                           want_levels=True, norms=norms),
                         reps=3, warmup=1)
    bound, by = _qsgd_bound([BIG_LEAF], 1, 0, elem=2, written=2 + 4)
    print("big leaf: " + json.dumps(dict(
        kernel="qsgd", leaf=list(BIG_LEAF), elements=rows * cols, dtype="bfloat16",
        clients=1, outputs="q and levels", ms=ms, quantize_pass_ms=quant_ms,
        norm_pass_ms=ms - quant_ms, bound_ms=bound, bound_by=by,
        over_bound=ms / bound, plain_ms=plain_ms)), flush=True)
    del norms
    torch.cuda.empty_cache()
    small = s.randn(1, 8, 8)
    check([x[:rows // 2][None], small], "second leaf at payload column 2^31")
    torch.cuda.empty_cache()
    return launches


def phase_dryrun(s: Smoke, proc, out):
    """Wait for the meta sweep (started as phase 19 began); one row per
    (arch, shape): the one-card argument and peak GiB, fits the card or
    not, the H100 bound and its dominant term, and the reference meshes'
    per-device argument GiB."""
    from repro_torch.configs.registry import ARCH_IDS
    from repro_torch.models.api import INPUT_SHAPES

    t0 = time.perf_counter()
    rc = proc.wait(timeout=900)
    waited = time.perf_counter() - t0
    if rc != 0:
        tail = (out / "sweep.log").read_text()[-3000:]
        raise AssertionError(f"dry run: the sweep exited {rc}:\n{tail}")
    fits = 0
    for arch in ARCH_IDS:
        for shape in INPUT_SHAPES:
            rec = {m: json.loads((out / f"{arch}__{shape}__{m}.json").read_text())
                   for m in ("one_card", "pod16x16", "pod2x16x16")}
            one = rec["one_card"]["per_device"]
            roof = rec["one_card"]["roofline"]
            fits += bool(one["fits"])
            print("dry run: " + json.dumps(dict(
                arch=arch, shape=shape,
                args_gib=one["argument_bytes"] / 2**30,
                peak_gib=one["peak_bytes_est"] / 2**30, fits=one["fits"],
                bound_s=roof["bound_s"], dominant=roof["dominant"],
                pod16x16_args_gib=rec["pod16x16"]["per_device"]["argument_bytes"] / 2**30,
                pod2x16x16_args_gib=rec["pod2x16x16"]["per_device"]["argument_bytes"]
                / 2**30, meta_s=rec["one_card"]["meta_s"])), flush=True)
    print(f"dry run: {len(ARCH_IDS) * len(INPUT_SHAPES)} combinations, {fits} fit "
          f"the card; waited {waited:.1f} s for the sweep", flush=True)


def _card_step(s: Smoke, fn, base):
    """Run ``fn`` once on the card → (seconds by CUDA events, peak bytes above
    ``base``)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    out = fn()
    e1.record()
    torch.cuda.synchronize()
    return out, e0.elapsed_time(e1) / 1e3, torch.cuda.max_memory_allocated() - base


def _meta_row(what, meta, card_s, card_bytes, roof, extra=None):
    """Print the card against the meta estimate; fail past META_TOL."""
    rel = abs(card_bytes - meta["peak_bytes"]) / meta["peak_bytes"]
    row = dict(step=what, meta_peak_gib=meta["peak_bytes"] / 2**30,
               card_peak_gib=card_bytes / 2**30, rel_diff=rel, card_s=card_s,
               bound_s=roof["bound_s"], dominant=roof["dominant"],
               over_bound=card_s / roof["bound_s"], meta_s=meta["seconds"],
               **(extra or {}))
    print("card vs meta: " + json.dumps(row), flush=True)
    if not rel <= META_TOL:
        raise AssertionError(f"card vs meta: {what}: card peak {card_bytes} against "
                             f"meta {meta['peak_bytes']} ({rel:.3f} > {META_TOL})")
    return row


def _fill_caches(caches, torch):
    """Every KV cache full: random k, v, positions 0 .. T−1 (a decode at T − 1)."""
    from repro_torch.models.attention import KVCache

    for c in caches.caches:
        if isinstance(c, KVCache):
            c.k.normal_()
            c.v.normal_()
            t = c.pos.shape[-1]
            c.pos.copy_(torch.arange(t, dtype=c.pos.dtype, device=c.pos.device)
                        .expand_as(c.pos))
            c.idx.fill_(t)


def phase_meta_vs_card(s: Smoke):
    """Each step on the card at the dry run's cuts, its max_memory_allocated
    (above what was allocated before its params) against the meta estimate
    (``launch/dryrun.py::measure_step``, full depth), its time against the
    one-card roofline bound: SmolLM-360M train_4k (N = 4, S = 2, batch 8),
    prefill_32k (batch 1), decode_32k (batch 16, caches full); Minitron-8B
    train_4k at full width and depth (N = 2, S = 1, batch 2) when its
    estimate fits, its close bitwise its plain version leaf by leaf."""
    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.core.projection import leaf_layout
    from repro_torch.core.tree import tree_leaves
    from repro_torch.kernels.seeded_reconstruct import reconstruct_plain
    from repro_torch.launch.dryrun import measure_step
    from repro_torch.launch.roofline import analytic_terms
    from repro_torch.launch.serve import make_decode_step, make_prefill_step
    from repro_torch.launch.train import FLRunConfig, make_train_step
    from repro_torch.models.api import INPUT_SHAPES

    capacity = torch.cuda.get_device_properties(0).total_memory
    counters = _train_counters()
    launches = {}
    arch = get_arch(TRAIN_ARCH)
    cfg = arch.cfg
    for shape, gb in (("train_4k", 8), ("prefill_32k", 1), ("decode_32k", 16)):
        seq = INPUT_SHAPES[shape][0]
        meta = measure_step(arch, shape, global_batch=gb)
        roof = analytic_terms(TRAIN_ARCH, shape, "one_card", global_batch=gb)
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        params = arch.init(seed=0, device=s.dev)
        counters.reset()
        if shape == "train_4k":
            toks = torch.randint(0, cfg.vocab_size, (gb, seq + 1), generator=s.gen,
                                 device=s.dev)
            batch = {"tokens": toks[:, :-1].to(torch.int32),
                     "labels": toks[:, 1:].to(torch.int32)}
            del toks
            step = make_train_step(arch, FLRunConfig(TRAIN_CLIENTS, TRAIN_STEPS,
                                                     local_lr=TRAIN_LR))
            (_, m), secs, peak = _card_step(s, lambda: step(params, batch, 0), base)
        elif shape == "prefill_32k":
            batch = {"tokens": torch.randint(0, cfg.vocab_size, (gb, seq),
                                             generator=s.gen, device=s.dev,
                                             dtype=torch.int32)}
            step = make_prefill_step(arch, capacity=seq)
            with torch.no_grad():
                _, secs, peak = _card_step(s, lambda: step(params, batch), base)
        else:
            caches = arch.init_caches(gb, seq, device=s.dev)
            _fill_caches(caches, torch)
            token = torch.randint(0, cfg.vocab_size, (gb, 1), generator=s.gen,
                                  device=s.dev, dtype=torch.int32)
            step = make_decode_step(arch, window=arch.serve_window(shape))
            with torch.no_grad():
                _, secs, peak = _card_step(s, lambda: step(params, token, caches,
                                                           seq - 1), base)
            del caches
        got = counters.moved()
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        _meta_row(f"{TRAIN_ARCH} {shape} batch {gb}", meta, secs, peak, roof,
                  dict(launches=got))
        del params
        torch.cuda.empty_cache()

    # Minitron-8B: 7.73e9 parameters, its stacked w_up/w_down 2³¹ elements each
    arch = get_arch(MINITRON)
    cfg = arch.cfg
    meta = measure_step(arch, "train_4k", global_batch=2, clients=2, local_steps=1)
    roof = analytic_terms(MINITRON, "train_4k", "one_card", global_batch=2,
                          clients=2, local_steps=1)
    if meta["peak_bytes"] > META_RUN_SHARE * capacity:
        print("card vs meta: " + json.dumps(dict(
            step=f"{MINITRON} train_4k", meta_peak_gib=meta["peak_bytes"] / 2**30,
            capacity_gib=capacity / 2**30, run=False)), flush=True)
        return launches
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = arch.init(seed=0, device=s.dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    toks = torch.randint(0, cfg.vocab_size, (2, 4097), generator=s.gen, device=s.dev)
    batch = {"tokens": toks[:, :-1].to(torch.int32), "labels": toks[:, 1:].to(torch.int32)}
    del toks
    step = make_train_step(arch, FLRunConfig(2, 1, local_lr=TRAIN_LR, server_lr=1.0))
    counters.reset()
    (new, m), secs, peak = _card_step(s, lambda: step(params, batch, 0), base)
    got = counters.moved()
    if got != {"encode": 4, "rec": 1}:
        raise AssertionError(f"card vs meta: {MINITRON}: launches {got}")
    for k, v in got.items():
        launches[k] = launches.get(k, 0) + v
    t1 = time.perf_counter()
    layout = leaf_layout(params)
    big = 0
    for ll, x, y in zip(layout, tree_leaves(params), tree_leaves(new)):
        big += ll.size >= 1 << 31
        x2, y2 = x.reshape(ll.rows, ll.cols), y.reshape(ll.rows, ll.cols)
        for r0 in range(0, ll.rows, BIG_SLAB_ROWS):
            want = reconstruct_plain(x2[r0:r0 + BIG_SLAB_ROWS], m["seeds"], m["r"],
                                     ll.tag, 1.0, None, None, row_offset=r0,
                                     orig_cols=ll.cols, per_client_rounding=True,
                                     div=2.0)
            if not torch.equal(y2[r0:r0 + BIG_SLAB_ROWS], want):
                raise AssertionError(f"card vs meta: {MINITRON}: the close differs "
                                     f"from its plain version at leaf {ll.tag}")
    if big < 2 or not math.isfinite(float(m["loss"])):
        raise AssertionError(f"card vs meta: {MINITRON}: {big} leaves of 2³¹, loss "
                             f"{float(m['loss'])}")
    _meta_row(f"{MINITRON} train_4k N=2 S=1 batch 2", meta, secs, peak, roof,
              dict(params=sum(ll.size for ll in layout), leaves_2_31=big,
                   init_s=init_s, loss=float(m["loss"]), close_bitwise_plain=True,
                   close_check_s=time.perf_counter() - t1, launches=got))
    del params, new, m, batch
    torch.cuda.empty_cache()
    return launches


def _client_parallel_checks(dev, arch, fl, params, batch) -> dict:
    """Both rounds of ``phase_client_parallel`` again, untimed, every
    encode's δ and r kept: each r within ``tree_encode_tolerance`` of the
    plain encode of its own δ; client n's client-parallel δ nearer client
    n's sequential δ than any other client's; each client-parallel r
    within ``CP_R_SIGMAS``·‖Δδ‖₂ and both encodes' tolerances of the
    sequential one.  Fails past a limit; → the figures."""
    import torch

    import repro_torch.kernels.ops as ops
    from repro_torch.core.tree import tree_leaves
    from repro_torch.kernels.seeded_projection import (
        project_tree_plain,
        tree_encode_tolerance,
    )
    from repro_torch.kernels.tree import tree_plan
    from repro_torch.launch.train import make_train_step, make_train_step_client_parallel

    n = fl.num_virtual_clients
    encode = ops.project_tree_kernel
    kept = {}
    for name, make in (("sequential", make_train_step),
                       ("client_parallel", make_train_step_client_parallel)):
        def keep(deltas, seeds, *args, _name=name):
            r = encode(deltas, seeds, *args)
            kept.setdefault(_name, []).append(
                ([x.clone() for x in tree_leaves(deltas)], seeds.clone(), r, args))
            return r

        ops.project_tree_kernel = keep
        try:
            new, _ = make(arch, fl)(params, batch, 1)
        finally:
            ops.project_tree_kernel = encode
        del new
    # (a) each encode within tree_encode_tolerance of its own δ's plain encode
    r_of, tol_of, worst = {}, {}, 0.0
    for name, calls in kept.items():
        rs, tols = [], []
        for leaves, seeds, r, (dist_enum, k, mode) in calls:
            distribution = dist_enum.value
            plan = tree_plan("encode", [tuple(x.shape[1:]) for x in leaves],
                             [x.dtype for x in leaves], k, mode, dev)
            want = project_tree_plain(leaves, seeds, plan, distribution,
                                      dtype=torch.float64)
            views = [x.reshape(x.shape[0], ll.rows, ll.cols)
                     for ll, x in zip(plan.layout, leaves)]
            tol = tree_encode_tolerance(views, distribution)
            ratio = float(((r.double() - want).abs() / tol).max())
            if not ratio <= 1.0:
                raise AssertionError(f"client parallel: {name} r {r.tolist()} "
                                     f"against the plain encode {want.tolist()}: "
                                     f"{ratio} of the tolerance")
            worst = max(worst, ratio)
            rs.append(r.double())
            tols.append(tol)
        r_of[name], tol_of[name] = torch.cat(rs), torch.cat(tols)
    # (b) client n's δ is client n's: nearest its own sequential δ
    seq_d = [c[0] for c in kept["sequential"]]
    par_d = kept["client_parallel"][0][0]
    dist = torch.zeros((n, n), dtype=torch.float64)
    for i in range(n):
        for j in range(n):
            dist[i, j] = sum(((a[i].float() - b[0].float()) ** 2).sum(dtype=torch.float64)
                             for a, b in zip(par_d, seq_d[j])).sqrt().item()
    own = dist.diagonal()
    other = (dist + torch.diag(torch.full((n,), float("inf"),
                                          dtype=torch.float64))).min(dim=1).values
    # (c) the rounds' r apart by no more than CP_R_SIGMAS·‖Δδ‖₂ and both
    # encodes' bounds: ⟨Δδ, v⟩ has standard deviation ‖Δδ‖₂ for a ±1 v
    # drawn apart from Δδ
    dr = (r_of["client_parallel"] - r_of["sequential"]).abs().cpu()
    r_lim = (CP_R_SIGMAS * own[:, None] + tol_of["client_parallel"].cpu()
             + tol_of["sequential"].cpu())
    r_rms = float(torch.sqrt((r_of["sequential"] ** 2).mean()))
    if not (bool((own < other).all()) and bool((dr <= r_lim).all())):
        raise AssertionError(f"client parallel: |δ_par − δ_seq| own {own.tolist()}, "
                             f"nearest other {other.tolist()}; |dr| "
                             f"{dr.flatten().tolist()} (limits "
                             f"{r_lim.flatten().tolist()}, r_rms {r_rms})")
    del kept, seq_d, par_d
    return dict(r_rms=r_rms, max_abs_dr=float(dr.max()), r_limit=r_lim.flatten().tolist(),
                r_err_over_tolerance=worst, delta_dist_own=own.tolist(),
                delta_dist_nearest_other=other.tolist())


def phase_client_parallel(s: Smoke):
    """``make_train_step_client_parallel`` against ``make_train_step``:
    SmolLM-360M at full width and depth, bf16, N = 4, S = 2, 1 × 4096 tokens
    a step, the same params, batch and seeds: one encode launch group for
    the four clients against four, the loss within 1%; both rounds' time
    and peak beside the client-parallel meta estimate.  Then both rounds
    again with every encode's δ kept: each client's r within
    ``tree_encode_tolerance`` of the plain encode of its own δ, each
    client-parallel δ nearer its own client's sequential δ than any
    other's, and each r within 6‖Δδ‖₂ plus both encodes' tolerances of
    the sequential step's (``_client_parallel_checks``).  Then float32 at 2 layers, the card
    against the CPU within phase 12's limits."""
    import numpy as np
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.launch.dryrun import measure_step
    from repro_torch.launch.roofline import analytic_terms
    from repro_torch.launch.train import (
        FLRunConfig,
        make_train_step,
        make_train_step_client_parallel,
    )
    from repro_torch.models.api import Arch

    n, st = TRAIN_CLIENTS, TRAIN_STEPS
    gb = n * st * TRAIN_PER_STEP
    arch = Arch(get_config(TRAIN_ARCH))
    cfg = arch.cfg
    fl = FLRunConfig(n, st, local_lr=TRAIN_LR, server_lr=1.0)
    meta = measure_step(arch, "train_4k", variant="client_parallel", global_batch=gb)
    roof = analytic_terms(TRAIN_ARCH, "train_4k", "one_card", global_batch=gb)
    capacity = torch.cuda.get_device_properties(0).total_memory
    if meta["peak_bytes"] > META_RUN_SHARE * capacity:
        raise AssertionError(f"client parallel: the meta estimate "
                             f"{meta['peak_bytes'] / 2**30:.2f} GiB does not fit")
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    params = arch.init(seed=0, device=s.dev)
    toks = torch.randint(0, cfg.vocab_size, (gb, TRAIN_SEQ + 1), generator=s.gen,
                         device=s.dev)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    fns = _train_counters()
    out = {}
    for name, make in (("sequential", make_train_step),
                       ("client_parallel", make_train_step_client_parallel)):
        step = make(arch, fl)
        fns.reset()
        (new, m), secs, peak = _card_step(s, lambda: step(params, batch, 1), base)
        out[name] = dict(m=m, s=secs, peak=peak,
                         launches=fns.moved())
        del new
        torch.cuda.empty_cache()
    seq_, par = out["sequential"], out["client_parallel"]
    if seq_["launches"] != {"encode": 2 * n, "rec": 1} or par["launches"] != {
            "encode": 2, "rec": 1}:
        raise AssertionError(f"client parallel: launches {seq_['launches']} "
                             f"(sequential), {par['launches']} (client-parallel)")
    l_seq, l_par = float(seq_["m"]["loss"]), float(par["m"]["loss"])
    dloss = abs(l_par - l_seq) / abs(l_seq)
    if not (dloss <= CP_LOSS_RTOL and torch.equal(par["m"]["seeds"],
                                                  seq_["m"]["seeds"])):
        raise AssertionError(f"client parallel: loss {l_par} vs {l_seq}")
    cp_launches = par["launches"]
    del out

    chk = _client_parallel_checks(s.dev, arch, fl, params, batch)
    _meta_row(f"{TRAIN_ARCH} train_4k client-parallel N={n} S={st} batch {gb}",
                    meta, par["s"], par["peak"], roof,
                    dict(sequential_s=seq_["s"],
                         sequential_peak_gib=seq_["peak"] / 2**30,
                         launches_sequential=seq_["launches"],
                         launches_client_parallel=par["launches"],
                         loss_sequential=l_seq, loss_client_parallel=l_par,
                         loss_rel_diff=dloss, **chk))
    del params, batch, toks, seq_, par
    torch.cuda.empty_cache()

    # float32, 2 layers: the card against the CPU (phase 12's limits)
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), num_layers=TRAIN_PARITY_LAYERS,
                              dtype="float32")
    arch = Arch(cfg)
    cpu = torch.device("cpu")
    p_cpu = arch.init(seed=0, device=cpu)
    p_dev = tree_map(lambda x: x.to(s.dev), p_cpu)
    toks = torch.from_numpy(np.random.RandomState(1).randint(
        0, cfg.vocab_size, (gb, TRAIN_PARITY_SEQ + 1)))
    step = make_train_step_client_parallel(arch, fl)
    res = {}
    for dev, p in ((s.dev, p_dev), (cpu, p_cpu)):
        fns.reset()
        res[dev.type] = step(p, {"tokens": toks[:, :-1].to(dev),
                                 "labels": toks[:, 1:].to(dev)}, 0)
        res[dev.type + "_launches"] = fns.moved()
    (p_g, m_g), (p_c, m_c) = res["cuda"], res["cpu"]
    dloss = abs(float(m_g["loss"]) - float(m_c["loss"]))
    r_g, r_c = m_g["r"].cpu().double(), m_c["r"].double()
    norm = float(torch.sqrt(sum((w.double() ** 2).sum() for w in tree_leaves(p_cpu))))
    r_lim = TRAIN_R_ULPS * st * 2.0 ** -24 * norm + TRAIN_R_RTOL * r_c.abs()
    d_r = (r_g - r_c).abs()
    p_tol = float(d_r.sum()) / n + 1e-6
    dp = max(float((a.cpu() - b).abs().max())
             for a, b in zip(tree_leaves(p_g), tree_leaves(p_c)))
    # one launch of each flash training kernel covers the N clients (vmap)
    calls = st * cfg.num_layers
    want = {"encode": 2, "rec": 1, "flash_f32": 2 * calls, "flash_bwd": calls}
    if not (dloss <= TRAIN_LOSS_ATOL and bool((d_r <= r_lim).all()) and dp <= p_tol
            and res["cuda_launches"] == want and res["cpu_launches"] == {}):
        raise AssertionError(f"client parallel: card vs CPU |dloss| {dloss}, |dr| "
                             f"{d_r.flatten().tolist()} (limits "
                             f"{r_lim.flatten().tolist()}), |dparams| {dp} (limit "
                             f"{p_tol}), launches {res['cuda_launches']}")
    print("client parallel f32: " + json.dumps(dict(
        layers=cfg.num_layers, seq=TRAIN_PARITY_SEQ, abs_dloss=dloss,
        loss_limit=TRAIN_LOSS_ATOL, max_dr_over_limit=float((d_r / r_lim).max()),
        max_abs_dparams=dp, dparams_limit=p_tol)), flush=True)
    del res, p_cpu, p_dev
    torch.cuda.empty_cache()
    return {**cp_launches, **{k: want[k] for k in ("flash_f32", "flash_bwd")}}


# Phase 20: the fused close's autotuner.  The sweep's workloads, (rows,
# cols, dtype, cohort, k): the paper MLP's dominant leaf (N = 20, bucket
# 32) and SmolLM-360M's tied embedding at the cohorts of phase 6.
TUNE_SWEEP = ((64, 24, "float32", 20, 1), (49152, 960, "float32", 256, 1),
              (49152, 960, "float32", 1024, 1), (49152, 960, "bfloat16", 256, 1))
SM90 = "cuda-sm_90a"


def _tile_checks(s: Smoke, params, n, family, k, mode, what, plain=True):
    """``ops.server_update_fused`` at every tile of ``tree.CLOSE_TILES``
    (one launch each) bitwise the default tile, and against the plain tree
    close as the default is (``plain``)."""
    import torch

    from repro_torch.core.prng import Distribution
    from repro_torch.core.projection import ProjectionMode
    from repro_torch.core.tree import tree_leaves
    from repro_torch.kernels import ops
    from repro_torch.kernels.reconstruct_apply import fused_tree_plain
    from repro_torch.kernels.tree import CLOSE_TILES, tree_plan

    mode = ProjectionMode(mode)
    dist = Distribution(family)
    seeds, rs = s.seeds(n), s.randn(n, k)
    leaves = tree_leaves(params)
    default = tree_leaves(ops.server_update_fused(params, rs, seeds, 0.9, dist,
                                                  mode=mode))
    want = None
    if plain:
        plan = tree_plan("close", [tuple(x.shape) for x in leaves],
                         [x.dtype for x in leaves], k, mode, s.dev)
        frs, scale = ops.fold_upload_weights(rs, 0.9, None, mode, None)
        want = fused_tree_plain(leaves, seeds, frs, scale, plan, family)
    for tile in CLOSE_TILES:
        before = _totals()["close.launches"]
        got = tree_leaves(ops.server_update_fused(params, rs, seeds, 0.9, dist,
                                                  mode=mode, block=tile))
        torch.cuda.synchronize()
        if _totals()["close.launches"] - before != 1:
            raise AssertionError(f"tune: tile {tile}: not one launch: {what}")
        if not all(torch.equal(g, d) for g, d in zip(got, default)):
            raise AssertionError(f"tune: tile {tile} differs from the default tile: "
                                 f"{what}")
        if want is not None:
            err = max(float((g.float() - w.float()).abs().max())
                      for g, w in zip(got, want))
            if not all(_decode_agrees(family, g, w) and bool(torch.isfinite(g).all())
                       for g, w in zip(got, want)):
                raise AssertionError(f"tune: tile {tile} disagrees with the plain "
                                     f"version: {what} max err {err}")
            s._record("fused", f"{family} tile={list(tile)}", err,
                      all(torch.equal(g, w) for g, w in zip(got, want)))


_TUNE_READER = """
import json, sys
from repro_torch.kernels import tune
print(json.dumps([tune.cached_fused_params(r, c, n, k, "rademacher",
                                           dtype_bits=b, backend={backend!r},
                                           cache_path={path!r})
                  for r, c, n, k, b in {work!r}]))
"""


def phase_tune(s: Smoke):
    """Phase 20: the fused close's autotuner (``kernels/tune.py``) with a
    temporary cache file.  The sweep at ``TUNE_SWEEP`` (each tile's median
    of 3 CUDA-event times beside its bound); every tile bitwise the default
    tile, and the plain version as the default is, for all four families
    (the MLP tree at k = 1, FULL 8 and BLOCK 8; the (960, 2560) leaf in
    BLOCK 8; the large leaf in float32 and bf16 against the default, and
    in float32 rademacher against the plain version); a second sweep with
    a measure that raises returns the stored winners, and so does another
    process; phase 5's fused-close run at 10⁵ clients with a non-default
    tile cached for its dominant leaf bitwise the run without.
    → per workload: the winner's and the default tile's ms."""
    import os
    import tempfile

    import numpy as np
    import torch

    from repro_torch.data import load_digits, make_client_datasets
    from repro_torch.data import train_test_split_arrays
    from repro_torch.fed.runtime import RuntimeConfig, run_federation
    from repro_torch.kernels import ops, tune
    from repro_torch.kernels.reconstruct_apply import fused_reconstruct_apply
    from repro_torch.kernels.tree import CLOSE_TILES, DEFAULT_CLOSE_TILE
    from repro_torch.models.mlp_classifier import init_mlp

    t0 = time.perf_counter()
    n0 = s.checks
    tmp = tempfile.TemporaryDirectory(prefix="fused-tune-")
    path = os.path.join(tmp.name, "fused_tune_torch.json")
    if tune.backend_of(s.dev) != SM90:
        raise AssertionError(f"tune: backend {tune.backend_of(s.dev)}, expected {SM90}")
    rows_out = []
    for rows, cols, dtype, n, k in TUNE_SWEEP:
        bits = 16 if dtype == "bfloat16" else 32
        bucket = tune.cohort_bucket(n)
        timer = tune._default_measure(rows, cols, bucket, k, "rademacher", bits, s.dev)
        ms = {}

        def measure(cand, timer=timer, ms=ms):
            sec = timer(cand)
            ms[tuple(cand["block"])] = sec * 1e3
            return sec

        won = tune.autotune_fused(rows, cols, n, k, "rademacher", bits,
                                  cache_path=path, measure=measure, device=s.dev)
        if set(ms) != set(CLOSE_TILES) or tuple(won["block"]) not in CLOSE_TILES:
            raise AssertionError(f"tune: sweep timed {sorted(ms)}, won {won}")

        def raising(cand):
            raise AssertionError(f"tune: a cache hit timed {cand}")

        again = tune.autotune_fused(rows, cols, n, k, "rademacher", bits,
                                    cache_path=path, measure=raising, device=s.dev)
        if again != won:
            raise AssertionError(f"tune: the hit returned {again}, stored {won}")
        bound, by = _fused_bound([(rows, cols)], bucket, k, elem=bits // 8)
        # The winner against the default in turns (default, winner, winner,
        # default; 5 calls each after a warm-up), as the sweep timed each
        # tile once, in CLOSE_TILES order.
        x = s.randn(rows, cols).to(getattr(torch, dtype))
        sd, rs = s.seeds(bucket), s.randn(bucket, k)
        turns = {}
        for name, block in (("default", None), ("winner", won["block"]),
                            ("winner2", won["block"]), ("default2", None)):
            turns[name] = s.time_ms(lambda b=block: fused_reconstruct_apply(
                x, sd, rs, 0, 0.01, block=b), reps=5, warmup=1)
        del x
        row = dict(shape=[rows, cols], dtype=dtype, cohort=n, bucket=bucket, k=k,
                   key=tune.cache_key(SM90, rows, cols, n, k, "rademacher", bits),
                   winner=won["block"], winner_ms=ms[tuple(won["block"])],
                   default=list(DEFAULT_CLOSE_TILE), default_ms=ms[DEFAULT_CLOSE_TILE],
                   winner_turns_ms=(turns["winner"] + turns["winner2"]) / 2,
                   default_turns_ms=(turns["default"] + turns["default2"]) / 2,
                   turns=turns, bound_ms=bound, bound_by=by,
                   tiles=[dict(tile=list(t), ms=ms[t], over_bound=ms[t] / bound)
                          for t in CLOSE_TILES])
        rows_out.append(row)
        print("tune: sweep " + json.dumps(row), flush=True)

    # Another process reads the same winners from the file.
    work = [(r, c, n, k, 16 if dt == "bfloat16" else 32)
            for r, c, dt, n, k in TUNE_SWEEP]
    out = subprocess.run(
        [sys.executable, "-c", _TUNE_READER.format(backend=SM90, path=path, work=work)],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(REPO / "src")))
    if out.returncode != 0:
        raise AssertionError(f"tune: the reading process failed:\n{out.stderr}")
    read = json.loads(out.stdout.strip().splitlines()[-1])
    if [r["block"] for r in read] != [row["winner"] for row in rows_out]:
        raise AssertionError(f"tune: another process read {read}")
    print(f"tune: another process read the same {len(read)} winners", flush=True)

    # Every tile: bitwise the default tile, and the plain version as it is.
    s.group = ("tune: every tile, the MLP tree (N=20; k=1, FULL 8, BLOCK 8) and "
               f"the block leaf {LARGE_BLOCK} (N=33, BLOCK 8), float32 and bf16")
    mlp = [(24,), (12,), (10,), (64, 24), (24, 12), (12, 10)]
    for dtype in (torch.float32, torch.bfloat16):
        for family in FAMILIES:
            for k, mode in ((1, "full"), (8, "full"), (8, "block")):
                _tile_checks(s, _rand_tree(s, mlp, dtype), 20, family, k, mode,
                             f"mlp tree {str(dtype)[6:]} {family} k={k} {mode}")
    for dtype in (torch.float32, torch.bfloat16):
        for family in FAMILIES:
            _tile_checks(s, {"w": s.randn(*LARGE_BLOCK).to(dtype)}, 33, family, 8,
                         "block", f"block leaf {str(dtype)[6:]} {family}")
    for dtype in (torch.float32, torch.bfloat16):
        params = {"w": s.randn(*LARGE).to(dtype)}
        for family in FAMILIES:
            _tile_checks(s, params, 256, family, 1, "full",
                         f"large leaf {str(dtype)[6:]} {family} N=256",
                         plain=dtype == torch.float32 and family == "rademacher")
        del params
    torch.cuda.empty_cache()
    s.report()

    # Phase 5's fused-close run with a non-default tile cached for its
    # dominant leaf (the MLP's (64, 24); cohort 1000, bucket 1024).
    x, y = load_digits()
    xtr, ytr, xte, yte = train_test_split_arrays(x, y)
    clients = make_client_datasets(xtr, ytr, RT_SHARDS)
    over, _ = RT_CONFIGS["fedscalar_fused"]
    cfg = RuntimeConfig(rounds=RT_ROUNDS, population=RT_POPULATION,
                        participation=RT_PARTICIPATION, eval_every=1, seed=0, **over)
    key = tune.cache_key(SM90, 64, 24, cfg.cohort_size(), 1, "rademacher", 32)
    cache = tune._load(path)
    tile = tuple(cache.setdefault(key, {"impl": "cuda", "block": list(CLOSE_TILES[-1]),
                                        "row_slab": None})["block"])
    if tile == DEFAULT_CLOSE_TILE:
        raise AssertionError(f"tune: {key} holds the default tile")
    tune._store(path, cache)
    blocks = []
    real_fused = ops.server_update_fused

    def spy(*args, **kwargs):
        blocks.append(kwargs.get("block"))
        return real_fused(*args, **kwargs)

    runs = {}
    saved = tune.DEFAULT_CACHE_PATH
    ops.server_update_fused = spy
    try:
        for name, cache_file in (("untuned", os.path.join(tmp.name, "none.json")),
                                 ("tuned", path)):
            tune.DEFAULT_CACHE_PATH = cache_file
            blocks.clear()
            runs[name] = run_federation(cfg, init_mlp(seed=0, device=s.dev), clients,
                                        xte, yte, device=s.dev)
            runs[name]["blocks"] = {str(b) for b in blocks}
    finally:
        tune.DEFAULT_CACHE_PATH = saved
        ops.server_update_fused = real_fused
    tuned, untuned = runs["tuned"], runs["untuned"]
    if (untuned["blocks"] != {"None"} or tuned["blocks"] != {str(list(tile))}
            or len(blocks) != RT_ROUNDS):
        raise AssertionError(f"tune: the runs passed tiles {untuned['blocks']} and "
                             f"{tuned['blocks']} over {len(blocks)} applies")
    same = all(torch.equal(tuned["final_params"][k], untuned["final_params"][k])
               for k in untuned["final_params"])
    if not same or not np.array_equal(tuned["loss"], untuned["loss"]):
        raise AssertionError("tune: the run with a tuned tile differs from the run "
                             "without")
    print("tune: " + json.dumps(dict(
        runtime=f"{RT_POPULATION} clients, {RT_ROUNDS} rounds, fused close",
        cached_tile=list(tile), key=key, bitwise_untuned=True)), flush=True)
    tmp.cleanup()
    print(f"tune: {s.checks - n0} tile checks, {time.perf_counter() - t0:.1f} s",
          flush=True)
    return [dict(shape=r["shape"], dtype=r["dtype"], cohort=r["cohort"],
                 winner=r["winner"], winner_ms=r["winner_turns_ms"],
                 default=r["default"], default_ms=r["default_turns_ms"],
                 bound_ms=r["bound_ms"])
            for r in rows_out]


# ---------------------------------------------------------------------------
# Phase 21: the train step on a device mesh
# ---------------------------------------------------------------------------

def _mesh_counted(counters, fn):
    """→ (fn's result, the launches it made by kernel)."""
    counters.reset()
    out = fn()
    return out, counters.moved()


def phase_mesh_train(s: Smoke):
    """SmolLM-360M's round on (1, 4) and (2, 2) meshes over the card against
    the unsharded round → the mesh rounds' encode and close launches."""
    import torch

    import repro_torch.kernels.ops as ops
    from repro_torch.configs.registry import get_config
    from repro_torch.core.projection import ProjectionMode
    from repro_torch.core.tree import tree_leaves
    from repro_torch.kernels.seeded_projection import (
        project_tree_plain,
        tree_encode_tolerance,
    )
    from repro_torch.kernels.tree import tree_plan
    from repro_torch.launch.mesh import make_fed_mesh
    from repro_torch.launch.train import FLRunConfig, make_train_step
    from repro_torch.models.api import Arch
    from repro_torch.sharding import fed_rules
    from repro_torch.sharding.resident import shard_resident
    from repro_torch.sharding.rules import param_specs, per_device_bytes

    t0 = time.perf_counter()
    cfg = get_config(TRAIN_ARCH)
    arch = Arch(cfg)
    params = arch.init(seed=0, device=s.dev)
    leaves = tree_leaves(params)
    n, st = MESH_CLIENTS, MESH_STEPS
    fl = FLRunConfig(num_virtual_clients=n, local_steps=st, local_lr=TRAIN_LR,
                     server_lr=1.0)
    toks = torch.randint(0, cfg.vocab_size, (MESH_BATCH, TRAIN_SEQ + 1),
                         generator=s.gen, device=s.dev)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    meshes = {shape: make_fed_mesh(shape, devices=[s.dev] * 4) for shape in MESH_SHAPES}
    counters = _train_counters()
    unsharded = make_train_step(arch, fl)
    steps = {shape: make_train_step(arch, fl, mesh=m) for shape, m in meshes.items()}
    resident = {shape: shard_resident(params, m) for shape, m in meshes.items()}
    plan = tree_plan("encode", [tuple(w.shape) for w in leaves], [w.dtype for w in leaves],
                     1, ProjectionMode.FULL, s.dev)

    # ---- the check rounds: δ, r and the close on (1, 4) ----
    deltas, u_rs, rows = [], [], []
    project, sharded = ops.project_tree_kernel, fed_rules.sharded_project_tree

    def spy_u(delta, seeds, *a):
        deltas.append([d[0].clone() for d in tree_leaves(delta)])
        r = project(delta, seeds, *a)
        u_rs.append(r[0])
        return r

    def spy_m(mesh, delta, seed, *a):
        i = len(rows)
        same = all(torch.equal(delta.gather(j, s.dev), w) for j, w in enumerate(deltas[i]))
        r = sharded(mesh, delta, seed, *a)
        exact = project_tree_plain([w[None] for w in deltas[i]], seed.reshape(1), plan,
                                   dtype=torch.float64)
        tol = tree_encode_tolerance([x[None] for x in delta.flat_shards()], "rademacher")
        err = abs(float(r[0]) - float(exact[0, 0]))
        rows.append(dict(client=i, delta_bitwise=same, r=float(r[0]),
                         unsharded_r=float(u_rs[i][0]), exact_r=float(exact[0, 0]),
                         err=err, tol=float(tol[0, 0])))
        return u_rs[i]                    # the close takes the unsharded r

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        ops.project_tree_kernel = spy_u
        (u_new, u_m), u_launch = _mesh_counted(counters, lambda: unsharded(params, batch, 0))
        ops.project_tree_kernel = project
        fed_rules.sharded_project_tree = spy_m
        (m_new, m_m), m_launch = _mesh_counted(
            counters, lambda: steps[(1, 4)](resident[(1, 4)], batch, 0))
    finally:
        ops.project_tree_kernel, fed_rules.sharded_project_tree = project, sharded
        torch.use_deterministic_algorithms(False)
    close_same = all(torch.equal(m_new.gather(j, s.dev), w)
                     for j, w in enumerate(tree_leaves(u_new)))
    loss_same = bool(torch.equal(m_m["loss"], u_m["loss"]))
    print("mesh check: " + json.dumps(dict(
        clients=rows, loss=float(u_m["loss"]), loss_bitwise=loss_same,
        close_bitwise_given_r=close_same, launches=[u_launch, m_launch])), flush=True)
    bad = [r for r in rows if not (r["delta_bitwise"] and r["err"] <= r["tol"])]
    if bad or not close_same or not loss_same:
        raise AssertionError(f"mesh: the (1, 4) round differs from the unsharded "
                             f"round: {bad}, close bitwise {close_same}, loss "
                             f"bitwise {loss_same}")
    del deltas, u_new, m_new

    # ---- the timed rounds ----
    stacked = sum(w.numel() * w.element_size() for key in arch.stacked_keys
                  if key in params for w in tree_leaves(params[key]))
    unstacked = sum(w.numel() * w.element_size() for w in leaves) - stacked
    out, launches = {}, {}
    for name in ("unsharded",) + MESH_SHAPES:
        if name == "unsharded":
            def run():
                return unsharded(params, batch, 1)
        else:
            def run(name=name):
                return steps[name](resident[name], batch, 1)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.memory_allocated()
        t1 = time.perf_counter()
        (new, m), got = _mesh_counted(counters, run)
        torch.cuda.synchronize()
        round_s = time.perf_counter() - t1
        peak = torch.cuda.max_memory_allocated()
        entries = 1 if name == "unsharded" else len(meshes[name].device_groups())
        want = {"encode": 2 * n * entries, "rec": entries}
        if got != want:
            raise AssertionError(f"mesh {name}: launches {got}, expected {want}")
        row = dict(mesh=str(name), round_s=round_s, peak_gib=peak / 2**30,
                   peak_above_start_gib=(peak - start) / 2**30,
                   train_tokens_per_s=MESH_BATCH * TRAIN_SEQ / round_s,
                   loss=float(m["loss"]), r=m["r"].flatten().tolist(), launches=got)
        if name != "unsharded":
            mesh = meshes[name]
            groups = len(mesh.data_groups())
            row.update(
                gathered_gb_per_step=groups * (2 * stacked + unstacked) / 1e9,
                resident_bytes_per_entry=new.resident_bytes(),
                per_device_bytes_param_specs=per_device_bytes(
                    arch.param_shapes(), param_specs(arch.param_shapes(), mesh), mesh))
            launches = {k: launches.get(k, 0) + v for k, v in got.items()}
        print("mesh round: " + json.dumps(row), flush=True)
        out[name] = (new, m, row)
    u_new, u_m, u_row = out["unsharded"]
    if not torch.equal(out[(1, 4)][1]["loss"], u_m["loss"]):
        raise AssertionError("mesh: the (1, 4) loss differs from the unsharded loss")
    # (2, 2): two data groups sum the loss and the gradients in another
    # order, so δ and r move (r within phase 13's bf16 bound); each new
    # element then moves by Σₙ|Δrₙ|/N, plus each client's reconstruction
    # rounded to bf16 on either side (2⁻⁸|rₙ|) and one bf16 ulp of the sum.
    new, m, row = out[(2, 2)]
    norm = math.sqrt(sum(float((w.float() ** 2).sum()) for w in leaves))
    r_tol = 2.0 ** -8 * math.sqrt(st) * norm
    dr = (m["r"] - u_m["r"]).abs()
    spread = float((dr + 2.0 ** -8 * (m["r"].abs() + u_m["r"].abs())).sum()) / n
    worst = 0.0
    for j, w in enumerate(tree_leaves(u_new)):
        a, b = new.gather(j, s.dev).float(), w.float()
        bound = spread + 2.0 ** -7 * torch.maximum(a.abs(), b.abs())
        worst = max(worst, float(((a - b).abs() / bound).max()))
    ok = (float(dr.max()) <= r_tol and worst <= 1.0
          and abs(float(m["loss"]) - float(u_m["loss"])) <= 1e-2)
    print("mesh (2, 2): " + json.dumps(dict(
        max_dr=float(dr.max()), r_tol=r_tol, params_worst_share_of_bound=worst,
        loss=float(m["loss"]), unsharded_loss=float(u_m["loss"]),
        round_s_over_unsharded={str(k): out[k][2]["round_s"] / u_row["round_s"]
                                for k in MESH_SHAPES},
        peak_over_unsharded={str(k): out[k][2]["peak_gib"] / u_row["peak_gib"]
                             for k in MESH_SHAPES},
        unstacked_gb=unstacked / 1e9, stacked_gb=stacked / 1e9)), flush=True)
    if not ok:
        raise AssertionError("mesh: the (2, 2) round is past its bounds")
    del out, resident, params, leaves, new, u_new
    torch.cuda.empty_cache()

    # ---- float32 (2, 2) against the float32 unsharded round ----
    arch32 = Arch(dataclasses.replace(cfg, dtype="float32"))
    p32 = arch32.init(seed=0, device=s.dev)
    mesh = meshes[(2, 2)]
    u_new, u_m = make_train_step(arch32, fl)(p32, batch, 2)
    (new, m), got = _mesh_counted(counters, lambda: make_train_step(
        arch32, fl, mesh=mesh)(shard_resident(p32, mesh), batch, 2))
    # float32 attention under autograd: each client's step runs the layers
    # once a data group, the flash kernel in a layer's forward and its
    # recompute, its backward once
    calls = n * st * len(mesh.data_groups()) * cfg.num_layers
    want = {"encode": 2 * n * len(mesh.device_groups()), "rec": len(mesh.device_groups()),
            "flash_f32": 2 * calls, "flash_bwd": calls}
    if got != want:
        raise AssertionError(f"mesh float32 (2, 2): launches {got}, expected {want}")
    launches = {k: launches.get(k, 0) + v for k, v in got.items()}
    dr = (m["r"] - u_m["r"]).abs()
    r_lim = MESH_F32_R_RTOL * (1 + u_m["r"].abs())
    spread = float(dr.sum()) / n + MESH_F32_PARAM_SLACK
    worst = max(float((new.gather(j, s.dev) - w).abs().max())
                for j, w in enumerate(tree_leaves(u_new)))
    dloss = abs(float(m["loss"]) - float(u_m["loss"]))
    print("mesh (2, 2) float32: " + json.dumps(dict(
        r=m["r"].flatten().tolist(), unsharded_r=u_m["r"].flatten().tolist(),
        dr=dr.flatten().tolist(), r_limit=r_lim.flatten().tolist(), dloss=dloss,
        loss_limit=MESH_F32_LOSS_ATOL, params_max_diff=worst, params_limit=spread,
        launches=got)), flush=True)
    if not (bool((dr <= r_lim).all()) and dloss <= MESH_F32_LOSS_ATOL and worst <= spread):
        raise AssertionError("mesh: the float32 (2, 2) round is past its bounds")
    del p32, u_new, new
    torch.cuda.empty_cache()
    print(f"mesh: {time.perf_counter() - t0:.1f} s", flush=True)
    return launches


# ---------------------------------------------------------------------------
# Phase 22: serving from resident shards on a mesh
# ---------------------------------------------------------------------------

def _keep_logits(arch, keep):
    """Wrap ``arch.prefill`` and ``arch.decode`` (which the serve steps call)
    to keep the last logits they return in ``keep["logits"]``."""
    for name in ("prefill", "decode"):
        def wrapped(*a, _fn=getattr(arch, name), **k):
            out = _fn(*a, **k)
            keep["logits"] = out[0]
            return out
        setattr(arch, name, wrapped)


def _mesh_serve_run(s: Smoke, arch, keep, params, inputs, groups):
    """One prefill of ``inputs`` and ``SERVE_GEN`` greedy steps through the
    serve steps, timed, the flash launches exact for ``groups`` data groups
    (one prefill launch per attention layer and group, one decode launch
    per attention layer, group and step) and no other kernel → the run's
    tokens, last logits (``keep``: :func:`_keep_logits`'), caches (a
    list, a group's each) and row."""
    import torch

    from repro_torch.launch.serve import make_decode_step, make_prefill_step

    batch = inputs["tokens"].shape[0]
    prefill = make_prefill_step(arch, capacity=SERVE_CAPACITY)
    decode = make_decode_step(arch)
    fns, counters = _kernel_fns(), _flash_counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    fns.reset()
    counters.reset()
    t0 = time.perf_counter()
    tok, caches = prefill(params, inputs)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    generated = [tok]
    t0 = time.perf_counter()
    for i in range(SERVE_GEN):
        tok, caches = decode(params, tok.reshape(batch, 1), caches, SERVE_PROMPT + i)
        generated.append(tok.reshape(batch))
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    launches = counters.read()
    stray = fns.moved()
    peak = torch.cuda.max_memory_allocated()
    n_attn = _attn_layers(arch.cfg)
    want = {"all": groups * n_attn * (1 + SERVE_GEN), "prefill": groups * n_attn,
            "decode": groups * n_attn * SERVE_GEN, "f32": 0}
    if launches != want or stray:
        raise AssertionError(f"mesh serve: flash launches {launches} (expected {want}), "
                             f"other kernels {stray}")
    row = dict(groups=groups, prefill_s=prefill_s,
               decode_ms_per_step=decode_s / SERVE_GEN * 1e3,
               peak_gib=peak / 2**30, peak_above_start_gib=(peak - start) / 2**30,
               flash_launches=launches)
    groups_caches = list(caches.groups) if hasattr(caches, "groups") else [caches]
    return torch.stack(generated, dim=1), keep["logits"], groups_caches, row


def _same_caches(a, b):
    """Every tensor of two LayerCaches equal."""
    import torch

    from repro_torch.core.tree import tree_leaves

    x, y = tree_leaves(tuple(a)), tree_leaves(tuple(b))
    return len(x) == len(y) and all(torch.equal(p, q) for p, q in zip(x, y))


def phase_mesh_serve(s: Smoke):
    """SmolLM-360M served from resident shards on (1, 4) and (2, 2) meshes
    of four entries on the card, in the reference's zero3 and tp layouts,
    against the unsharded serve → the flash launches."""
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.launch.mesh import make_fed_mesh
    from repro_torch.models.api import Arch
    from repro_torch.sharding.resident import place_rows, shard_resident

    t0 = time.perf_counter()
    cfg = get_config(SERVE_ARCH)
    arch = Arch(cfg)
    params = arch.init(seed=0, device=s.dev)
    inputs = _frontend(cfg, SERVE_BATCH, SERVE_PROMPT, gen=s.gen, device=s.dev)
    # warm-up on a short prompt (cuBLAS handles, the allocator): no flash
    with torch.no_grad():
        warm = {"tokens": inputs["tokens"][:, :64]}
        _, caches = arch.prefill(params, warm, capacity=80)
    del caches
    keep = {}
    _keep_logits(arch, keep)
    half = SERVE_BATCH // 2
    launches = {"prefill": 0, "decode": 0, "f32": 0}
    rows = {}

    def count(row):
        for k in launches:
            launches[k] += row["flash_launches"][k]

    with torch.no_grad():
        u_tok, u_logits, u_caches, u_row = _mesh_serve_run(s, arch, keep, params, inputs, 1)
        count(u_row)
        rows["unsharded"] = u_row
        own = []
        for g in range(2):
            part = {k: v[g * half:(g + 1) * half] for k, v in inputs.items()}
            tok, logits, caches, row = _mesh_serve_run(s, arch, keep, params, part, 1)
            count(row)
            rows[f"unsharded rows {g * half}-{(g + 1) * half - 1}"] = row
            own.append((tok, logits, caches[0]))
        checks = {}
        for shape in MESH_SHAPES:
            mesh = make_fed_mesh(shape, devices=[s.dev] * 4)
            for layout, place in (("zero3", shard_resident), ("tp", place_rows)):
                placed = place(params, mesh)
                tok, logits, caches, row = _mesh_serve_run(s, arch, keep, placed,
                                                           inputs, shape[0])
                count(row)
                name = f"{shape} {layout}"
                if shape[0] == 1:
                    ok = (torch.equal(tok, u_tok) and torch.equal(logits, u_logits)
                          and _same_caches(caches[0], u_caches[0]))
                else:
                    ok = all(torch.equal(tok[g * half:(g + 1) * half], own[g][0])
                             and torch.equal(logits[g * half:(g + 1) * half], own[g][1])
                             and _same_caches(caches[g], own[g][2]) for g in range(2))
                row.update(resident_bytes_per_entry=placed.resident_bytes(),
                           prefill_over_unsharded=row["prefill_s"] / u_row["prefill_s"],
                           decode_over_unsharded=(row["decode_ms_per_step"]
                                                  / u_row["decode_ms_per_step"]))
                rows[name], checks[name] = row, ok
                del placed, caches, tok, logits
    for name, row in rows.items():
        print(f"mesh serve {name}: " + json.dumps(row), flush=True)
    print("mesh serve checks (tokens, last logits and caches bitwise: (1, 4) the "
          "unsharded serve's, (2, 2) each group its own rows'): " + json.dumps(checks),
          flush=True)
    if not all(checks.values()):
        raise AssertionError(f"mesh serve: {checks}")
    del params, u_caches, own
    torch.cuda.empty_cache()
    print(f"mesh serve: {time.perf_counter() - t0:.1f} s", flush=True)
    return launches


# ---------------------------------------------------------------------------
# Phase 23: the client-parallel step on a mesh
# ---------------------------------------------------------------------------

def phase_mesh_client_parallel(s: Smoke):
    """SmolLM-360M's client-parallel round on a (2, 2) mesh of four entries
    on the card (a client a data row, each replica over its row's two
    entries) against the one-device client-parallel round → launches."""
    import torch

    import repro_torch.kernels.ops as ops
    from repro_torch.configs.registry import get_config
    from repro_torch.core.projection import ProjectionMode
    from repro_torch.core.tree import tree_leaves
    from repro_torch.kernels.seeded_projection import (
        project_tree_plain,
        tree_encode_tolerance,
    )
    from repro_torch.kernels.tree import tree_plan
    from repro_torch.launch.dryrun import measure_fit
    from repro_torch.launch.mesh import make_fed_mesh
    from repro_torch.launch.train import FLRunConfig, make_train_step_client_parallel
    from repro_torch.models.api import Arch
    from repro_torch.sharding import fed_rules
    from repro_torch.sharding.resident import place_rows, shard_resident
    from repro_torch.sharding.rules import param_specs, per_device_bytes

    t0 = time.perf_counter()
    n, st = MESH_CP_CLIENTS, MESH_CP_STEPS
    gb = n * st * TRAIN_PER_STEP
    arch = Arch(get_config(TRAIN_ARCH))
    cfg = arch.cfg
    fl = FLRunConfig(n, st, local_lr=TRAIN_LR, server_lr=1.0)
    meta = measure_fit(arch, "train_4k", variant="client_parallel", global_batch=gb,
                       clients=n, local_steps=st)
    params = arch.init(seed=0, device=s.dev)
    leaves = tree_leaves(params)
    toks = torch.randint(0, cfg.vocab_size, (gb, TRAIN_SEQ + 1), generator=s.gen,
                         device=s.dev)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    mesh = make_fed_mesh((2, 2), devices=[s.dev] * 4)
    x = shard_resident(params, mesh)
    counters = _train_counters()
    one_device = make_train_step_client_parallel(arch, fl)
    on_mesh = make_train_step_client_parallel(arch, fl, param_specs(params, mesh,
                                                                    layout="tp"),
                                              mesh=mesh)
    per = n // mesh.shape[0]
    plan = tree_plan("encode", [tuple(w.shape) for w in leaves], [w.dtype for w in leaves],
                     1, ProjectionMode.FULL, s.dev)

    def timed(fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.memory_allocated()
        t1 = time.perf_counter()
        out, got = _mesh_counted(counters, fn)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        return out, got, dict(round_s=time.perf_counter() - t1, peak_gib=peak / 2**30,
                              peak_above_start_gib=(peak - start) / 2**30, launches=got)

    # ---- the timed rounds: one device, then the mesh ----
    (u_new, u_m), u_launch, u_row = timed(lambda: one_device(params, batch, 1))
    (m_new, m_m), m_launch, m_row = timed(lambda: on_mesh(x, batch, 1))
    entries = len(mesh.row_mesh(0).device_groups())
    want = {"encode": 2 * entries * n, "rec": len(mesh.device_groups())}
    if u_launch != {"encode": 2, "rec": 1} or m_launch != want:
        raise AssertionError(f"mesh client parallel: launches {u_launch} (one device), "
                             f"{m_launch} (mesh; expected {want})")
    launches = {k: u_launch.get(k, 0) + m_launch.get(k, 0) for k in ("encode", "rec")}
    del m_new

    # ---- the check rounds (deterministic algorithms: the embedding's
    # backward sums in one order) ----
    encode, sharded = ops.project_tree_kernel, fed_rules.sharded_project_tree
    row_deltas, checks = [], []

    def keep(d, seeds, *a):
        stacked = tree_leaves(d)
        row_deltas.extend([w[c].clone() for w in stacked]
                          for c in range(stacked[0].shape[0]))
        return encode(d, seeds, *a)

    def check(row_mesh, delta, seed, *a):
        i = len(checks)
        r = sharded(row_mesh, delta, seed, *a)
        same = all(torch.equal(delta.gather(j, s.dev), w)
                   for j, w in enumerate(row_deltas[i]))
        exact = project_tree_plain([w[None] for w in row_deltas[i]], seed.reshape(1),
                                   plan, dtype=torch.float64)
        tol = tree_encode_tolerance([w[None] for w in delta.flat_shards()], "rademacher")
        checks.append(dict(client=i, delta_bitwise=same, r=float(r[0]),
                           exact_r=float(exact[0, 0]),
                           err=abs(float(r[0]) - float(exact[0, 0])),
                           tol=float(tol[0, 0])))
        return u_m["r"][i].to(r.dtype)      # the close takes the one-device r

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        ops.project_tree_kernel = keep
        row_fl = FLRunConfig(per, st, local_lr=TRAIN_LR, server_lr=1.0)
        for r in range(mesh.shape[0]):
            rows = slice(r * per * st * TRAIN_PER_STEP, (r + 1) * per * st * TRAIN_PER_STEP)
            _, got = _mesh_counted(counters, lambda: make_train_step_client_parallel(
                arch, row_fl)(params, {k: v[rows] for k, v in batch.items()}, 1))
            launches = {k: launches[k] + got.get(k, 0) for k in launches}
        ops.project_tree_kernel = encode
        fed_rules.sharded_project_tree = check
        (c_new, _), got = _mesh_counted(counters, lambda: on_mesh(x, batch, 1))
        launches = {k: launches[k] + got.get(k, 0) for k in launches}
    finally:
        ops.project_tree_kernel, fed_rules.sharded_project_tree = encode, sharded
        torch.use_deterministic_algorithms(False)
    close_same = all(torch.equal(c_new.gather(j, s.dev), w)
                     for j, w in enumerate(tree_leaves(u_new)))
    replica = place_rows(x, mesh).rows[0]
    tp_bytes = per_device_bytes(arch.param_shapes(), param_specs(arch.param_shapes(), mesh,
                                                                 layout="tp"), mesh)
    print("mesh client parallel: " + json.dumps(dict(
        one_device=u_row, mesh=m_row, round_s_over_one_device=m_row["round_s"]
        / u_row["round_s"], meta_peak_gib=meta["peak_bytes"] / 2**30,
        loss=float(m_m["loss"]), one_device_loss=float(u_m["loss"]),
        clients=checks, close_bitwise_given_r=close_same,
        replica_resident_bytes_per_entry=replica.resident_bytes(),
        per_device_bytes_tp_specs=tp_bytes,
        x_resident_bytes_per_entry=x.resident_bytes())), flush=True)
    bad = [c for c in checks if not (c["delta_bitwise"] and c["err"] <= c["tol"])]
    if bad or not close_same or len(checks) != n:
        raise AssertionError(f"mesh client parallel: {bad}, close bitwise {close_same}")
    del params, x, u_new, c_new, row_deltas, replica
    torch.cuda.empty_cache()
    print(f"mesh client parallel: {time.perf_counter() - t0:.1f} s", flush=True)
    return launches


def main() -> int:
    src = REPO / "src"
    if not (src / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: src/repro_torch is missing; run from a checkout of "
              "the repository", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    name, count, smi_line = phase_device(torch)
    phase_build()
    return _run(torch, t0, name, count, smi_line)


def _phase_19(s: Smoke, torch):
    """Phase 19, with the meta sweep running beside its card steps (none of
    whose times enter the ``kernels`` line) → the three paths' launches."""
    sweep, sweep_out = start_dryrun_sweep(torch)
    try:
        big_launches = phase_big_leaf(s)
        mc_launches = phase_meta_vs_card(s)
        cp_launches = phase_client_parallel(s)
        phase_dryrun(s, sweep, sweep_out)
    finally:
        if sweep.poll() is None:
            import os
            import signal

            os.killpg(sweep.pid, signal.SIGKILL)
            sweep.wait()
        sweep.log.close()
    return big_launches, mc_launches, cp_launches


def _run(torch, t0, name, count, smi_line) -> int:
    s = Smoke(torch)
    phase_kernels(s)
    phase_kernels_runtime(s)
    phase_tree_kernels(s)
    launches = phase_main_path(s)
    rt_launches, _ = phase_runtime(s)
    sh_launches, _ = phase_sharded(s)
    for k in ("encode", "fused"):
        launches[k] += rt_launches[k] + sh_launches[k]
    times = phase_times(s)
    times.update(phase_times_runtime(s))
    phase_flash(s)
    flash_rows = phase_flash_times(s)
    f32_launches = phase_serve_parity(s)
    serve_launches = phase_serve(s, flash_rows)
    fam_launches = phase_families_parity(s)
    fam_serve = phase_families_serve(s)
    phase_train_kernels(s)
    parity_launches = phase_train_parity(s)
    long_launches = phase_train_long(s)
    train_launches = phase_train(s)
    hd256_rows = phase_flash_hd256(s)
    vlm_launches = phase_vlm_encdec_parity(s)
    vlm_serve = phase_vlm_encdec_serve(s, hd256_rows)
    phase_vlm_encdec_train(s)
    big_launches, mc_launches, cp_launches = _phase_19(s, torch)
    tuned = phase_tune(s)
    mesh_launches = phase_mesh_train(s)
    serve_mesh = phase_mesh_serve(s)
    cp_mesh = phase_mesh_client_parallel(s)
    flash_train = phase_flash_train(s)
    for part in (mesh_launches, cp_mesh):
        launches["encode"] += part.get("encode", 0)
        train_launches["rec"] = train_launches.get("rec", 0) + part.get("rec", 0)
    launches["qsgd"] += big_launches.get("qsgd", 0)
    # phase 19's paths: the 2³² leaf, the card-vs-meta steps, the
    # client-parallel round
    for part in (big_launches, mc_launches, cp_launches):
        launches["encode"] += part.get("encode", 0)
        launches["fused"] += part.get("fused", 0)
        train_launches["rec"] = train_launches.get("rec", 0) + part.get("rec", 0)
    flash_launches = {"prefill": serve_launches["prefill"],
                      "decode": serve_launches["decode"], "f32": f32_launches}
    for k in flash_launches:
        flash_launches[k] += (fam_launches[k] + fam_serve[k] + vlm_launches[k]
                              + vlm_serve[k] + mc_launches.get(f"flash_{k}", 0)
                              + serve_mesh[k])
    # float32 training's attention (phases 12, 15, 19's client-parallel
    # round and 21's float32 mesh round): the float32 kernel forward, and
    # its backward
    for part in (parity_launches, long_launches, cp_launches, mesh_launches):
        flash_launches["f32"] += part.get("flash_f32", 0)
        flash_launches["bwd"] = flash_launches.get("bwd", 0) + part.get("flash_bwd", 0)
    kernels = [
        dict(name="seeded_projection", route="cuda",
             source="src/repro_torch/kernels/csrc/seeded_projection.cu",
             replaces="src/repro/kernels/seeded_projection.py:57",
             launches=launches["encode"] + train_launches["encode"],
             max_abs_err=s.errs["encode"],
             library_ms=None, **times["encode"]),
        dict(name="reconstruct_apply", route="cuda",
             source="src/repro_torch/kernels/csrc/reconstruct_apply.cu",
             replaces="src/repro/kernels/reconstruct_apply.py:134",
             launches=launches["fused"], max_abs_err=s.errs["fused"],
             library_ms=None, tuned=tuned, **times["fused"]),
        dict(name="seeded_reconstruct", route="cuda",
             source="src/repro_torch/kernels/csrc/seeded_reconstruct.cu",
             replaces="src/repro/kernels/seeded_reconstruct.py:60",
             launches=rt_launches["rec"] + sh_launches["rec"] + train_launches["rec"],
             max_abs_err=s.errs["rec"],
             library_ms=None, **times["rec"]),
        dict(name="qsgd_quant", route="cuda",
             source="src/repro_torch/kernels/csrc/qsgd_quant.cu",
             replaces="src/repro/kernels/qsgd_quant.py:31",
             launches=launches["qsgd"] + rt_launches["qsgd"],
             max_abs_err=s.errs["qsgd"],
             library_ms=None, **times["qsgd"]),
    ]
    # The flash kernels: prefill and decode carry the serve paths (launches
    # from phases 10, 17 and 18); the float32 kernel carries the parity
    # paths' prefill (launches from phases 9, 17 and 18) and float32
    # training's forward (12, 15, 19, 21), the backward float32 training's.
    # Times at the SmolLM-360M shapes (phase 8); phase 18 prints the
    # head_dim-256 ones; the backward's at Minitron-8B's attention (24).
    for route, kernel in FLASH_KERNELS.items():
        fr = flash_rows[route]
        kernels.append(dict(
            name=kernel, route="cuda",
            source=f"src/repro_torch/kernels/csrc/{kernel}.cu",
            replaces="src/repro/kernels/flash_attention.py:40",
            launches=flash_launches[route], max_abs_err=s.errs[kernel],
            ms=fr["ms"], plain_ms=fr["plain_ms"], bound_ms=fr["bound_ms"],
            bound_by=fr["bound_by"], library_ms=fr["library_ms"]))
    fb = flash_train["bwd"]
    kernels.append(dict(
        name="flash_attention_bwd", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention_bwd.cu", replaces=None,
        launches=flash_launches["bwd"],
        max_grad_err_over_plain_max=fb["max_grad_err_over_plain_max"], ms=fb["ms"],
        plain_ms=fb["plain_ms"], bound_ms=fb["bound_ms"], bound_by="operations",
        library_ms=None))
    print(f"total {time.perf_counter() - t0:.1f} s")
    print(smi_line)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

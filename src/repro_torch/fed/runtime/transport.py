"""The wire: uplink frame codecs, lossy channel, downlink disciplines.

Copy of ``repro/fed/runtime/transport.py`` (numpy only), except for
bf16: the reference takes its bf16 dtype from ``ml_dtypes``, which the
port does not depend on.  Here a bf16 scalar is rounded by a
``torch.bfloat16`` cast (round to nearest, ties to even, subnormals
kept) and stored as its ``uint16`` bit pattern, which gives the same
bytes as the reference.

Everything the paper abstracts as "upload two scalars" is made concrete
here (DESIGN.md §1/§5; the k-scalar generalization is §6, the protocol
frame taxonomy §8, the downlink disciplines §9).  Three frame types
ride the uplink, one per registered protocol
(:mod:`repro_torch.fed.protocols`):

    scalar    [ r₀ … r_{k−1} | ξ ]       k scalars + u32 seed (fedscalar)
    dense     [ δ₀ … δ_{d−1} ]           d values at scalar width (fedavg)
    quantized [ ℓ₀ … ℓ_{d−1} | norms ]   d signed int8 level codes +
                                         one f32 norm per leaf (qsgd)

all little-endian — 8 bytes per client per round for the paper's
protocol (k = 1, fp32 r), Θ(d) bytes for the baselines.  Every codec's
``bits_per_upload`` delegates to the matching
:mod:`repro_torch.fed.costmodel` formula (``upload_bits`` /
``dense_upload_bits`` / ``quantized_upload_bits``), so eq. (12)/(13)
accounting and the bytes actually serialized share one source.  The
server aggregates whatever the *decoded* value is, so wire
quantization error flows through the estimator exactly as it would in
deployment.  The direction family never rides the wire: the server
resolves it from round configuration, and regenerating v from ξ is
family-agnostic by construction (DESIGN §1).

Shapes/dtypes: every codec maps a float32 payload vector of length
``payload_dim`` (+ a u32 seed, scalar frames only) to
``bytes_per_upload`` bytes and back; a cohort transmit takes float32
``(C, payload_dim)`` and uint32 ``(C,)`` and returns the decoded
float32 ``(C, payload_dim)`` plus per-upload latency/loss.

The channel model rides on :class:`repro_torch.fed.costmodel.CostModel`: one
independent lognormal rate draw per upload gives per-upload latencies
(this is what makes stragglers), ``ChannelConfig.drop_prob`` loses
packets outright, and ``base_latency_s`` adds fixed access overhead.

The downlink (DESIGN §9) has **two wire disciplines**:

* ``dense``  — the status quo: the server broadcasts the full model,
  d floats per round (now honestly priced into wall/energy),
* ``digest`` — FedScalar only: the server broadcasts a
  :class:`RoundDigest` — ``(round, seeds, coefficients, scalars)`` for
  the round's applied uploads, O(C·k) scalars independent of d — and
  **stateful clients** replay the identical parameter update locally
  from the seeded directions.  A bounded :class:`RoundLog` keeps the
  last W encoded digests so a client that missed rounds fetches the
  log suffix and replays forward; a gap beyond the window falls back
  to one dense model sync.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.fed.costmodel import (
    DIGEST_HEADER_BITS,
    FLOAT32_BYTES,
    UINT32_BYTES,
    CostModel,
    bits_to_bytes,
    bytes_to_bits,
    dense_downlink_bits,
    dense_upload_bits,
    digest_downlink_bits,
    quantized_upload_bits,
    upload_bits,
)

__all__ = [
    "SCALAR_WIDTHS",
    "to_wire",
    "from_wire",
    "WireFormat",
    "DenseFrameCodec",
    "QuantizedFrameCodec",
    "encode_upload",
    "decode_upload",
    "UplinkChannel",
    "TransmitResult",
    "RoundDigest",
    "DigestCodec",
    "RoundLog",
    "DownlinkChannel",
]


# name → (factory of the wire storage dtype, bits per scalar)
SCALAR_WIDTHS = {
    "fp32": (lambda: np.dtype("<f4"), 32),
    "fp16": (lambda: np.dtype("<f2"), 16),
    "bf16": (lambda: np.dtype("<u2"), 16),   # bfloat16 bit patterns
}


def to_wire(values: np.ndarray, scalar: str) -> np.ndarray:
    """float32 values → contiguous wire storage of width ``scalar``."""
    values = np.asarray(values, np.float32)
    if scalar == "bf16":
        import torch

        bits = torch.from_numpy(np.ascontiguousarray(values)).to(torch.bfloat16)
        return np.ascontiguousarray(bits.view(torch.int16).numpy().view("<u2"))
    return np.ascontiguousarray(values.astype(SCALAR_WIDTHS[scalar][0]()))


def from_wire(stored: np.ndarray, scalar: str) -> np.ndarray:
    """Wire storage of width ``scalar`` → float32 values (exact)."""
    if scalar == "bf16":
        wide = np.asarray(stored, "<u2").astype(np.uint32) << 16
        return wide.view(np.float32)
    return np.asarray(stored).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class WireFormat:
    """Uplink packet layout: k projection/block scalars + one u32 seed.

    ``num_projections`` is k — one scalar per parameter block in BLOCK
    mode, or m independent full-d projections (DESIGN §6); the frame
    layout is identical either way.
    """

    scalar: str = "fp32"          # width of each r scalar
    num_projections: int = 1      # k

    def __post_init__(self):
        if self.scalar not in SCALAR_WIDTHS:
            raise ValueError(
                f"unknown scalar format {self.scalar!r}; want {list(SCALAR_WIDTHS)}")

    @property
    def k(self) -> int:
        """Scalars per frame (alias of ``num_projections``)."""
        return self.num_projections

    @property
    def scalar_dtype(self) -> np.dtype:
        return SCALAR_WIDTHS[self.scalar][0]()

    @property
    def payload_dim(self) -> int:
        """Length of the float32 payload vector this codec carries."""
        return self.num_projections

    @property
    def bits_per_upload(self) -> int:
        return upload_bits(self.num_projections, SCALAR_WIDTHS[self.scalar][1])

    @property
    def bytes_per_upload(self) -> int:
        return bits_to_bytes(self.bits_per_upload)

    def encode(self, payload: np.ndarray, seed: int) -> bytes:
        return encode_upload(payload, seed, self)

    def decode(self, buf: bytes) -> tuple[np.ndarray, int]:
        return decode_upload(buf, self)

    def encode_batch(self, payloads: np.ndarray, seeds: np.ndarray) -> bytes:
        """Vectorized cohort encode: C concatenated frames, one call.

        Byte-identical to ``b"".join(encode(row, seed) …)`` (asserted
        in ``tests/test_statistical.py``) without the O(C) interpreter
        round-trips — the 100k-client uplink runs through here.
        """
        c = len(seeds)
        payloads = np.ascontiguousarray(
            np.asarray(payloads, np.float32).reshape(c, self.num_projections))
        body = to_wire(payloads, self.scalar)
        w = self.scalar_dtype.itemsize * self.num_projections
        buf = np.empty((c, self.bytes_per_upload), np.uint8)
        buf[:, :w] = body.view(np.uint8).reshape(c, w)
        buf[:, w:] = np.ascontiguousarray(
            np.asarray(seeds, "<u4")).view(np.uint8).reshape(c, 4)
        return buf.tobytes()

    def decode_batch(self, buf: bytes, count: int) -> tuple[np.ndarray, np.ndarray]:
        """→ (float32 (C, k) payloads, uint32 (C,) seeds) — exact inverse."""
        if len(buf) != count * self.bytes_per_upload:
            raise ValueError(
                f"batch is {len(buf)} B, expected {count * self.bytes_per_upload}")
        rows = np.frombuffer(buf, np.uint8).reshape(count, self.bytes_per_upload)
        w = self.scalar_dtype.itemsize * self.num_projections
        body = np.ascontiguousarray(rows[:, :w]).view(self.scalar_dtype)
        seeds = np.ascontiguousarray(rows[:, w:]).view("<u4").reshape(count)
        return from_wire(body, self.scalar).reshape(count, self.num_projections), \
            seeds.astype(np.uint32)


@dataclasses.dataclass(frozen=True)
class DenseFrameCodec:
    """FedAvg's uplink packet: the full d-dimensional update, no seed.

    ``[ δ₀ … δ_{d−1} ]`` at ``scalar`` width, little-endian.  fp32 is
    the paper's baseline (byte-exact round trip); fp16/bf16 are the
    honest half-width variants — the server aggregates the decoded
    values, so wire rounding flows into the trajectory.
    """

    d: int                        # model dimension (payload length)
    scalar: str = "fp32"          # wire width of each value

    def __post_init__(self):
        if self.scalar not in SCALAR_WIDTHS:
            raise ValueError(
                f"unknown scalar format {self.scalar!r}; want {list(SCALAR_WIDTHS)}")
        if self.d <= 0:
            raise ValueError(f"dense frame needs d > 0, got {self.d}")

    @property
    def payload_dim(self) -> int:
        return self.d

    @property
    def bits_per_upload(self) -> int:
        """Θ(d) — delegates to the costmodel's dense-frame single source."""
        return dense_upload_bits(self.d, SCALAR_WIDTHS[self.scalar][1])

    @property
    def bytes_per_upload(self) -> int:
        return bits_to_bytes(self.bits_per_upload)

    def encode(self, payload: np.ndarray, seed: int = 0) -> bytes:
        """Serialize one dense update; the seed never rides this frame."""
        del seed
        payload = np.asarray(payload, np.float32).reshape(-1)
        if payload.shape != (self.d,):
            raise ValueError(f"expected {self.d} values, got {payload.shape}")
        return to_wire(payload, self.scalar).tobytes()

    def decode(self, buf: bytes) -> tuple[np.ndarray, int]:
        if len(buf) != self.bytes_per_upload:
            raise ValueError(f"packet is {len(buf)} B, expected {self.bytes_per_upload}")
        vals = np.frombuffer(buf, dtype=self.scalar_dtype, count=self.d)
        return from_wire(vals, self.scalar), 0

    def encode_batch(self, payloads: np.ndarray,
                     seeds: np.ndarray | None = None) -> bytes:
        """Vectorized cohort encode — C dense frames, byte-identical to
        concatenating :meth:`encode` per row (seedless frames: the seed
        argument exists only for interface uniformity)."""
        del seeds
        payloads = np.asarray(payloads, np.float32).reshape(-1, self.d)
        return to_wire(payloads, self.scalar).tobytes()

    def decode_batch(self, buf: bytes, count: int) -> tuple[np.ndarray, np.ndarray]:
        if len(buf) != count * self.bytes_per_upload:
            raise ValueError(
                f"batch is {len(buf)} B, expected {count * self.bytes_per_upload}")
        vals = np.frombuffer(buf, dtype=self.scalar_dtype).reshape(count, self.d)
        return from_wire(vals, self.scalar), np.zeros(count, np.uint32)

    @property
    def scalar_dtype(self) -> np.dtype:
        return SCALAR_WIDTHS[self.scalar][0]()


@dataclasses.dataclass(frozen=True)
class QuantizedFrameCodec:
    """QSGD's uplink packet: d signed level codes + one norm per leaf.

    ``[ ℓ₀ … ℓ_{d−1} | n₀ … n_{L−1} ]`` with ℓ an int8 signed level in
    [−(2^{bits−1}−1), 2^{bits−1}−1] and n float32 L2 norms.  The engine-
    side payload is the float32 vector ``[levels | norms]`` (levels are
    exact small integers in float32), so decode∘encode is byte- and
    value-exact and the server's dequantize reproduces the client's
    round-trip bit-for-bit (repro_torch.core.qsgd).

    ``bits_per_upload`` delegates to
    :func:`repro_torch.fed.costmodel.quantized_upload_bits` (``d·bits +
    L·32``, the paper's formula with per-leaf norms); the reference
    serializer stores levels byte-aligned (int8), so for ``bits < 8``
    the accounted bits are the ideal bit-packed size while the bytes on
    this simulated wire are ``d + 4L``.  At the paper's 8-bit
    comparison point the two coincide exactly.
    """

    d: int                        # total quantized elements
    num_norms: int = 1            # L: one norm per quantized tensor
    bits: int = 8                 # level-code width (≤ 8: int8 storage)
    norm_bits: int = 32

    def __post_init__(self):
        if not 2 <= self.bits <= 8:
            raise ValueError(f"level codes must be 2..8 bits, got {self.bits}")
        if self.d <= 0 or self.num_norms <= 0:
            raise ValueError(f"need d > 0 and num_norms > 0: {self.d}, {self.num_norms}")

    @property
    def payload_dim(self) -> int:
        return self.d + self.num_norms

    @property
    def bits_per_upload(self) -> int:
        """d·bits + L·norm_bits — the costmodel single source (Table I)."""
        return quantized_upload_bits(self.d, self.bits, self.num_norms,
                                     self.norm_bits)

    @property
    def bytes_per_upload(self) -> int:
        # int8 level codes (1 B each) + float32 norms; the *priced*
        # payload (bits_per_upload) stays d·bits — wire honesty gap
        # is the frame's byte alignment, not the accounting's.
        return self.d + FLOAT32_BYTES * self.num_norms

    def encode(self, payload: np.ndarray, seed: int = 0) -> bytes:
        """Serialize ``[levels | norms]`` float32 payload → bytes."""
        del seed
        payload = np.asarray(payload, np.float32).reshape(-1)
        if payload.shape != (self.payload_dim,):
            raise ValueError(
                f"expected {self.payload_dim} payload values, got {payload.shape}")
        levels = payload[:self.d]
        lim = (1 << (self.bits - 1)) - 1
        if np.any(np.abs(levels) > lim) or np.any(levels != np.round(levels)):
            raise ValueError(f"level codes must be integers in ±{lim}")
        return levels.astype(np.int8).tobytes() + payload[self.d:].astype("<f4").tobytes()

    def decode(self, buf: bytes) -> tuple[np.ndarray, int]:
        if len(buf) != self.bytes_per_upload:
            raise ValueError(f"packet is {len(buf)} B, expected {self.bytes_per_upload}")
        levels = np.frombuffer(buf, dtype=np.int8, count=self.d).astype(np.float32)
        norms = np.frombuffer(buf, dtype="<f4", count=self.num_norms,
                              offset=self.d)
        return np.concatenate([levels, norms.astype(np.float32)]), 0

    def encode_batch(self, payloads: np.ndarray,
                     seeds: np.ndarray | None = None) -> bytes:
        """Vectorized cohort encode — byte-identical to per-row encode."""
        del seeds
        payloads = np.asarray(payloads, np.float32).reshape(-1, self.payload_dim)
        c = payloads.shape[0]
        levels = payloads[:, :self.d]
        lim = (1 << (self.bits - 1)) - 1
        if np.any(np.abs(levels) > lim) or np.any(levels != np.round(levels)):
            raise ValueError(f"level codes must be integers in ±{lim}")
        buf = np.empty((c, self.bytes_per_upload), np.uint8)
        buf[:, :self.d] = levels.astype(np.int8).view(np.uint8)
        buf[:, self.d:] = np.ascontiguousarray(
            payloads[:, self.d:].astype("<f4")).view(np.uint8).reshape(
                c, FLOAT32_BYTES * self.num_norms)
        return buf.tobytes()

    def decode_batch(self, buf: bytes, count: int) -> tuple[np.ndarray, np.ndarray]:
        if len(buf) != count * self.bytes_per_upload:
            raise ValueError(
                f"batch is {len(buf)} B, expected {count * self.bytes_per_upload}")
        rows = np.frombuffer(buf, np.uint8).reshape(count, self.bytes_per_upload)
        levels = np.ascontiguousarray(
            rows[:, :self.d]).view(np.int8).astype(np.float32)
        norms = np.ascontiguousarray(
            rows[:, self.d:]).view("<f4").astype(np.float32)
        return np.concatenate([levels, norms], axis=1), np.zeros(count, np.uint32)


def encode_upload(r: np.ndarray, seed: int, fmt: WireFormat) -> bytes:
    """Serialize one client's upload → ``fmt.bytes_per_upload`` bytes."""
    r = np.asarray(r, np.float32).reshape(-1)
    if r.shape != (fmt.num_projections,):
        raise ValueError(f"expected {fmt.num_projections} scalars, got {r.shape}")
    scalars = to_wire(r, fmt.scalar).tobytes()
    return scalars + np.asarray(seed, dtype="<u4").tobytes()


def decode_upload(buf: bytes, fmt: WireFormat) -> tuple[np.ndarray, int]:
    """→ (float32 r̂ of shape (m,), seed).  Exact inverse of the bytes:
    ``encode_upload(*decode_upload(buf, fmt), fmt) == buf``."""
    if len(buf) != fmt.bytes_per_upload:
        raise ValueError(f"packet is {len(buf)} B, expected {fmt.bytes_per_upload}")
    m = fmt.num_projections
    body = np.frombuffer(buf, dtype=fmt.scalar_dtype, count=m, offset=0)
    seed = int(np.frombuffer(buf, dtype="<u4", count=1,
                             offset=m * fmt.scalar_dtype.itemsize)[0])
    return from_wire(body, fmt.scalar), seed


@dataclasses.dataclass
class TransmitResult:
    """Per-upload outcome of one round's cohort uplink."""

    r_hat: np.ndarray          # (C, payload_dim) float32 — decoded payloads
    seeds: np.ndarray          # (C,) uint32 — decoded seeds (0 for seedless frames)
    latency_s: np.ndarray      # (C,) arrival latency after dispatch
    lost: np.ndarray           # (C,) bool — dropped in the air
    payload_bytes: int         # total uplink payload offered (incl. lost)


class UplinkChannel:
    """Serialize and channel-simulate one cohort's uplink per round.

    ``fmt`` is any frame codec (:class:`WireFormat`,
    :class:`DenseFrameCodec`, :class:`QuantizedFrameCodec`): anything
    with ``payload_dim`` / ``bits_per_upload`` / ``bytes_per_upload``
    and ``encode``/``decode``.
    """

    def __init__(self, cost_model: CostModel, fmt):
        self.cm = cost_model
        self.fmt = fmt

    def transmit(self, rs: np.ndarray, seeds: np.ndarray) -> TransmitResult:
        """rs (C, payload_dim) float32, seeds (C,) u32 → :class:`TransmitResult`.

        Every upload really goes through bytes: the payloads the server
        aggregates are the *decoded* ones, so fp16/bf16 wire widths are
        honestly lossy while fp32 (and integer level codes) are
        byte-exact.  Serialization runs through the codec's vectorized
        batch path — byte-identical to per-frame encode/decode
        (``tests/test_statistical.py``) without O(C) interpreter
        round-trips per round.
        """
        c = len(seeds)
        rs = np.asarray(rs, np.float32).reshape(c, -1)
        blob = self.fmt.encode_batch(rs, np.asarray(seeds, np.uint32))
        r_hat, seeds_hat = self.fmt.decode_batch(blob, c)
        latency = self.cm.per_client_upload_seconds(self.fmt.bits_per_upload, c)
        lost = self.cm.per_client_drops(c)
        return TransmitResult(
            r_hat=r_hat, seeds=seeds_hat, latency_s=latency, lost=lost,
            payload_bytes=c * self.fmt.bytes_per_upload)


# ---------------------------------------------------------------------------
# downlink: round digests, the bounded catch-up log, and the channel
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RoundDigest:
    """One round's server update as scalars: enough to replay it locally.

    The FedScalar server step is x ← x + lr·Σᵢ cᵢ·rᵢⱼ·vⱼ(ξᵢ) — a
    weighted sum of seed-generated directions — so ``(seeds, coeffs,
    rs)`` for the round's applied uploads *is* the update (DESIGN §9).
    A stateful client feeds the digest through the identical
    aggregation code path (:class:`repro_torch.fed.runtime.engine.
    StatefulClient`), reproducing the server's new parameters
    bit-for-bit.

    ``coeffs=None`` marks a uniform-mean round (full arrival, the
    paper's aggregation): replay uses the exact 1/A mean path and the
    coefficient column never rides the wire.  An empty digest
    (``num_uploads == 0``) is a recorded no-op round — the log stays
    contiguous across skipped rounds.
    """

    round_idx: int
    seeds: np.ndarray                 # (A,) uint32 cohort seeds ξ
    rs: np.ndarray                    # (A, k) float32 decoded upload scalars
    coeffs: np.ndarray | None = None  # (A,) float32 HT×staleness weights

    @property
    def num_uploads(self) -> int:
        return int(self.seeds.shape[0])

    @property
    def uniform_mean(self) -> bool:
        return self.coeffs is None

    @property
    def num_blocks(self) -> int:
        return int(self.rs.shape[1]) if self.rs.ndim == 2 else 1


@dataclasses.dataclass(frozen=True)
class DigestCodec:
    """Round-digest wire format, little-endian (DESIGN §9):

        [ round u32 | A u32 | k u32 | flags u32 |
          ξ₀ … ξ_{A−1} u32 | (c₀ … c_{A−1} f32)? | r₀ … r_{A·k−1} f32 ]

    flags bit 0 marks a uniform-mean digest (no coefficient column).
    ``bits_for`` delegates to :func:`repro_torch.fed.costmodel.
    digest_downlink_bits`, so the engine's accounting and the bytes
    actually serialized share one source — asserted per encode.
    """

    num_blocks: int = 1

    _UNIFORM_FLAG = 0x1

    def bits_for(self, num_uploads: int, include_coeffs: bool = True) -> int:
        return digest_downlink_bits(num_uploads, self.num_blocks,
                                    include_coeffs=include_coeffs)

    def encode(self, dg: RoundDigest) -> bytes:
        a = dg.num_uploads
        rs = np.ascontiguousarray(np.asarray(dg.rs, np.float32))
        rs = rs.reshape(a, -1) if a else np.zeros((0, self.num_blocks),
                                                  np.float32)
        if a and rs.shape[1] != self.num_blocks:
            raise ValueError(f"digest carries k={rs.shape[1]} scalars per "
                             f"upload, codec expects {self.num_blocks}")
        flags = self._UNIFORM_FLAG if dg.uniform_mean else 0
        head = np.asarray([dg.round_idx, a, self.num_blocks, flags],
                          "<u4").tobytes()
        body = np.ascontiguousarray(np.asarray(dg.seeds, "<u4")).tobytes()
        if not dg.uniform_mean:
            body += np.ascontiguousarray(
                np.asarray(dg.coeffs, "<f4")).tobytes()
        buf = head + body + rs.astype("<f4").tobytes()
        assert bytes_to_bits(len(buf)) == self.bits_for(a, not dg.uniform_mean), \
            "digest serializer drifted from digest_downlink_bits"
        return buf

    def decode(self, buf: bytes) -> RoundDigest:
        round_idx, a, k, flags = (int(v) for v in
                                  np.frombuffer(buf, "<u4", count=4))
        if k != self.num_blocks:
            raise ValueError(f"digest has k={k}, codec expects {self.num_blocks}")
        uniform = bool(flags & self._UNIFORM_FLAG)
        if bytes_to_bits(len(buf)) != self.bits_for(a, include_coeffs=not uniform):
            raise ValueError(f"digest is {len(buf)} B, expected "
                             f"{bits_to_bytes(self.bits_for(a, not uniform))}")
        off = bits_to_bytes(DIGEST_HEADER_BITS)
        seeds = np.frombuffer(buf, "<u4", count=a, offset=off).astype(np.uint32)
        off += UINT32_BYTES * a
        coeffs = None
        if not uniform:
            coeffs = np.frombuffer(buf, "<f4", count=a,
                                   offset=off).astype(np.float32)
            off += FLOAT32_BYTES * a
        rs = np.frombuffer(buf, "<f4", count=a * k, offset=off).astype(
            np.float32).reshape(a, k)
        return RoundDigest(round_idx=round_idx, seeds=seeds, rs=rs,
                           coeffs=coeffs)


class RoundLog:
    """Bounded log of encoded round digests — the catch-up path.

    Keeps the last ``window`` encoded digests in append order.  A
    client that missed rounds fetches the contiguous suffix from its
    last applied round and replays forward; once the gap exceeds the
    window the suffix is gone and the caller must fall back to a dense
    model sync (DESIGN §9).  Digests are stored *encoded* so the log's
    memory is exactly the bits a real server would retain, and replay
    decodes through the same codec the wire uses.
    """

    def __init__(self, codec: DigestCodec, window: int = 64):
        if window < 1:
            raise ValueError(f"log window must be ≥ 1, got {window}")
        self.codec = codec
        self.window = int(window)
        self._frames: dict[int, bytes] = {}
        # prefix[r] = total encoded bits of digests [0, r); kept for the
        # retained range so suffix_bits is O(1) — the engine prices a
        # catch-up per sampled client per round, which must not become
        # an O(cohort · window) interpreter loop at 100k-client scale.
        self._prefix: dict[int, int] = {0: 0}
        self._next = 0

    @property
    def next_round(self) -> int:
        """The round index the next appended digest must carry."""
        return self._next

    def append(self, dg: RoundDigest) -> int:
        """Append round ``next_round``'s digest → its encoded bits."""
        if dg.round_idx != self._next:
            raise ValueError(
                f"log expects round {self._next}, got {dg.round_idx}")
        buf = self.codec.encode(dg)
        self._frames[dg.round_idx] = buf
        self._prefix[self._next + 1] = (self._prefix[self._next]
                                        + bytes_to_bits(len(buf)))
        self._next += 1
        evict = self._next - self.window - 1
        if evict in self._frames:
            del self._frames[evict]
            del self._prefix[evict]
        return bytes_to_bits(len(buf))

    def suffix_bits(self, from_round: int,
                    to_round: int | None = None) -> int | None:
        """Bits to ship digests [from_round, to_round); None = evicted.

        ``to_round`` defaults to the log head: under the synchronous
        engine a sampled client always syncs to the round about to
        run.  The pipelined scheduler syncs clients to the **params
        version** a round reads — which lags the head by the pipeline
        depth — so catch-up must price an intermediate prefix, not
        whatever happens to be appended by then.  O(1): a prefix-sum
        difference over the retained range.
        """
        to = self._next if to_round is None else min(int(to_round), self._next)
        if from_round >= to:
            return 0
        if from_round < self._next - self.window or from_round < 0:
            return None
        return self._prefix[to] - self._prefix[from_round]

    def replay(self, from_round: int,
               to_round: int | None = None) -> list[RoundDigest] | None:
        """Decode the suffix [from_round, to_round); None = evicted."""
        to = self._next if to_round is None else min(int(to_round), self._next)
        if self.suffix_bits(from_round, to) is None:
            return None
        return [self.codec.decode(self._frames[k])
                for k in range(from_round, to)]


class DownlinkChannel:
    """Server → clients downlink under one of two wire disciplines.

    ``dense``  — every round broadcasts the full model: ``d ·
    float_bits`` bits (one wireless transmission serves the cohort),
    and sampled clients are always current.  This is the paper's
    "server broadcasts x_k", previously counted but never priced.

    ``digest`` — the round's closing :class:`RoundDigest` is broadcast
    (O(C·k) scalars) and appended to the bounded :class:`RoundLog`;
    a client sampled after missing rounds first pays the **catch-up**
    traffic — the unicast log suffix from its last synced round, or a
    dense fallback resync when the gap exceeds the log window.

    ``total_bits`` accumulates *all* downlink traffic (broadcasts +
    catch-up) and is reconciled against the engine's per-round history
    at the end of every run, so bits cannot silently vanish (the old
    ``DownlinkBroadcast`` stub counted them into a field nothing read).
    """

    def __init__(self, cost_model: CostModel, model_dim: int,
                 float_bits: int = 32, mode: str = "dense",
                 digest_codec: DigestCodec | None = None,
                 log_window: int = 64):
        if mode not in ("dense", "digest"):
            raise ValueError(f"unknown downlink mode {mode!r}; "
                             "want 'dense' or 'digest'")
        if mode == "digest" and digest_codec is None:
            raise ValueError("digest downlink needs a DigestCodec")
        self.cm = cost_model
        self.mode = mode
        self.dense_bits = dense_downlink_bits(model_dim, float_bits)
        self.log = RoundLog(digest_codec, log_window) if mode == "digest" else None
        self.total_bits = 0
        self.broadcast_bits = 0
        self.catchup_bits = 0
        self.dense_resyncs = 0
        self.rounds = 0

    def broadcast(self, digest: RoundDigest | None = None) -> int:
        """Account one round's closing broadcast → bits sent.

        Dense mode ignores ``digest``; digest mode requires it (an
        empty digest for skipped rounds keeps the log contiguous).
        """
        if self.mode == "dense":
            bits = self.dense_bits
        else:
            if digest is None:
                raise ValueError("digest downlink: every round must "
                                 "broadcast a RoundDigest (empty for no-ops)")
            bits = self.log.append(digest)
        self.total_bits += bits
        self.broadcast_bits += bits
        self.rounds += 1
        return bits

    def catch_up(self, client_round: int, target_round: int) -> tuple[int, str]:
        """Price one sampled client's sync to ``target_round``.

        → ``(bits, kind)`` with kind ``'current'`` (no gap),
        ``'digest'`` (log-suffix replay) or ``'dense'`` (gap beyond
        the log window → full model resync).  Dense mode is always
        current: the per-round broadcast already ships the model.
        """
        if self.mode == "dense" or client_round >= target_round:
            return 0, "current"
        bits = self.log.suffix_bits(client_round, target_round)
        if bits is None:
            self.total_bits += self.dense_bits
            self.catchup_bits += self.dense_bits
            self.dense_resyncs += 1
            return self.dense_bits, "dense"
        self.total_bits += bits
        self.catchup_bits += bits
        return bits, "digest"

    def catch_up_batch(self, client_rounds: np.ndarray,
                       target_round: int) -> tuple[int, int, int]:
        """Price a whole cohort's sync in one shot → (bits, n_digest, n_dense).

        Bit- and counter-identical to looping :meth:`catch_up` over
        ``client_rounds`` (asserted in ``tests/test_scheduler.py``)
        but vectorized: one O(window) prefix-table build plus numpy
        lookups, instead of an O(cohort) interpreter loop per round —
        the digest catch-up was the engine's last per-client Python
        loop, and it is what a 10⁵-member cohort stalls on.
        """
        rounds = np.asarray(client_rounds, np.int64)
        if self.mode == "dense" or len(rounds) == 0:
            return 0, 0, 0
        log = self.log
        target = min(int(target_round), log.next_round)
        behind = rounds < target
        if not behind.any():
            return 0, 0, 0
        lo = max(0, log.next_round - log.window)
        dense = behind & (rounds < lo)
        digest = behind & ~dense
        n_dense = int(dense.sum())
        n_digest = int(digest.sum())
        bits = n_dense * self.dense_bits
        if n_digest:
            pref = np.asarray(
                [log._prefix[r] for r in range(lo, log.next_round + 1)],
                np.int64)
            bits += int(np.sum(pref[target - lo] - pref[rounds[digest] - lo]))
        self.total_bits += bits
        self.catchup_bits += bits
        self.dense_resyncs += n_dense
        return bits, n_digest, n_dense

    def round_cost(self, bits: float) -> tuple[float, float, float]:
        """(bits, wall_s, energy_J) of one round's downlink traffic —
        deterministic, via :meth:`CostModel.downlink_cost` (12′)/(13′)."""
        return self.cm.downlink_cost(bits)

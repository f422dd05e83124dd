"""System-level cost model: wall-clock (eq. 12) and energy (eq. 13).

The part of ``repro/fed/costmodel.py`` that ``run_simulation`` and
``upload_bits_per_client`` use, copied (numpy only):

    T_wall = T_other + B_upload / R        E_round = P_tx · B_upload / R

with a mean-one lognormal fluctuation on the uplink rate R per round and
T_other pegged to FedAvg's nominal upload time.  The same
``np.random.RandomState`` stream gives the same figures as the reference.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = [
    "ChannelConfig",
    "CostModel",
    "upload_bits",
    "dense_upload_bits",
    "BYTE_BITS",
    "FLOAT32_BYTES",
    "UINT32_BYTES",
]

#: Bits per octet.
BYTE_BITS = 8
#: Widths of the primitive wire cells, in bytes.
FLOAT32_BYTES = 32 // BYTE_BITS
UINT32_BYTES = 32 // BYTE_BITS


def upload_bits(num_blocks: int = 1, scalar_bits: int = 32,
                seed_bits: int = 32) -> int:
    """Uplink payload per client per round for a k-block-scalar frame."""
    return num_blocks * scalar_bits + seed_bits


def dense_upload_bits(d: int, value_bits: int = 32) -> int:
    """FedAvg-style dense frame: d values at full width."""
    return d * value_bits


@dataclasses.dataclass(frozen=True)
class ChannelConfig:
    bandwidth_bps: float = 0.1e6       # nominal uplink R
    lognormal_sigma: float = 0.25      # channel fluctuation (multiplicative)
    p_tx_watts: float = 2.0            # transmit power
    t_other_frac: float = 0.05         # T_other as fraction of FedAvg upload time
    access: str = "concurrent"         # or "tdma"
    num_clients: int = 20
    float_bits: int = 32


class CostModel:
    """Accumulates bits / seconds / joules across rounds for one method."""

    def __init__(self, channel: ChannelConfig, fedavg_bits_per_client: int,
                 rng_seed: int = 0):
        self.ch = channel
        self._rng = np.random.RandomState(rng_seed)
        fedavg_upload_s = fedavg_bits_per_client / channel.bandwidth_bps
        self.t_other = channel.t_other_frac * fedavg_upload_s

    def round_cost(self, bits_per_client: int) -> tuple[float, float, float]:
        """→ (uploaded_bits_total, wall_seconds, energy_joules) for one round."""
        ch = self.ch
        fluct = self._rng.lognormal(mean=-0.5 * ch.lognormal_sigma**2,
                                    sigma=ch.lognormal_sigma)
        rate = ch.bandwidth_bps * fluct
        per_client_s = bits_per_client / rate
        if ch.access == "tdma":
            upload_s = ch.num_clients * per_client_s
        else:
            upload_s = per_client_s
        total_bits = ch.num_clients * bits_per_client
        wall = self.t_other + upload_s
        energy = ch.num_clients * ch.p_tx_watts * per_client_s
        return float(total_bits), float(wall), float(energy)

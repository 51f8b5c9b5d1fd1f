"""Tier specifications for the hierarchical cloud/edge/device fleet.

The paper's three tiers (Section II) carry a compute rate (FLOPS) and a
network function (latency + bandwidth from the data source, which by
assumption (a) is the device tier). The TPU-native fleet maps the same
structure onto pod-slice / host-slice / single-chip tiers (DESIGN.md §2).
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, Tuple

# v5e hardware constants (also used by the roofline analysis). They are
# inputs of a MODELLED fleet (`--tiers tpu`, DESIGN.md §2) that the
# scheduler plans for, not measurements of this package or of the GPU it
# runs on.
TPU_PEAK_FLOPS = 197e12      # bf16 FLOP/s per chip
TPU_HBM_BW = 819e9           # bytes/s per chip
TPU_ICI_BW = 50e9            # bytes/s per link
DCN_BW = 25e9 / 8            # ~25 Gb/s host DCN, bytes/s
DCN_LATENCY = 1e-3           # cross-metro DCN round trip budget (one-way)
LAN_BW = 10e9 / 8            # edge LAN
LAN_LATENCY = 50e-6


@dataclass(frozen=True)
class TierSpec:
    """One tier of the hierarchy.

    flops:        aggregate peak FLOP/s of one machine at this tier.
    net_latency:  one-way latency (s) from the data source to this tier.
    net_bw:       bandwidth (bytes/s) from the data source to this tier.
    machines:     number of shared machines at this tier.
    private:      device tier — every job owns its machine (paper Sec. V).
    hbm_bw:       aggregate memory bandwidth (beyond-paper roofline model).
    efficiency:   de-rate on peak flops (e.g. measured roofline fraction).
    """
    name: str
    flops: float
    net_latency: float = 0.0
    net_bw: float = float("inf")
    machines: int = 1
    private: bool = False
    hbm_bw: float = 0.0
    efficiency: float = 1.0

    @property
    def effective_flops(self) -> float:
        return self.flops * self.efficiency


# Paper tier ids
CC, ES, ED = "cloud", "edge", "device"


def paper_tiers() -> Dict[str, TierSpec]:
    """The paper's experimental testbed (Section VII, Table III + [36])."""
    return {
        CC: TierSpec(CC, flops=422.4e9, net_latency=42e-3, net_bw=2.9e6),
        ES: TierSpec(ES, flops=140.8e9, net_latency=0.239e-3, net_bw=10e6),
        ED: TierSpec(ED, flops=96e9, private=True),
    }


def tpu_tiers(*, cloud_chips: int = 512, edge_chips: int = 16,
              device_chips: int = 1) -> Dict[str, TierSpec]:
    """TPU-fleet analogue: multi-pod cloud slice, host-slice edge, one-chip
    device co-located with the request source (DESIGN.md §2)."""
    return {
        CC: TierSpec(CC, flops=cloud_chips * TPU_PEAK_FLOPS,
                     net_latency=DCN_LATENCY, net_bw=DCN_BW,
                     hbm_bw=cloud_chips * TPU_HBM_BW),
        ES: TierSpec(ES, flops=edge_chips * TPU_PEAK_FLOPS,
                     net_latency=LAN_LATENCY, net_bw=LAN_BW,
                     hbm_bw=edge_chips * TPU_HBM_BW),
        ED: TierSpec(ED, flops=device_chips * TPU_PEAK_FLOPS,
                     private=True, hbm_bw=device_chips * TPU_HBM_BW),
    }


TIER_ORDER: Tuple[str, str, str] = (CC, ES, ED)

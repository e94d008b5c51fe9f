"""Hardware profiles — the roofline and cost-model denominators.

Port of ``src/repro/roofline/constants.py`` for the port's one card. Every
roofline ratio and every ``analysis.cost`` CostReport divides by a
profile's peaks, so a report names the profile it assumed.
``HardwareProfile`` makes the denominators a value, ``PROFILES`` the named
registry and ``DEFAULT_PROFILE`` the one the passes take unless told
otherwise; the flat module constants are the default profile's fields.

There is one profile, ``h100-sxm-80gb``: NVIDIA's public peaks for the
H100 SXM5 80 GB at its 700 W power limit (the limit ``nvidia-smi`` read on
the card PERF.md's numbers come from) — 989 TFLOP/s dense bf16 on the
tensor cores, 3.35 TB/s of HBM3, 450 GB/s each way over NVLink 4 to the
other cards of one HGX host (``link_bw``; the reference's field was
``ici_bw``), 8 cards a host and 80 GB of device memory. A card set below
700 W runs slower under load than these peaks say. The numbers are peak
specs, not measurements.
"""
from __future__ import annotations

import dataclasses
from typing import Dict


@dataclasses.dataclass(frozen=True)
class HardwareProfile:
    """Per-card peak numbers a roofline/cost estimate divides by."""
    name: str
    peak_flops_bf16: float     # FLOP/s, dense bf16 tensor-core
    hbm_bw: float              # B/s
    link_bw: float             # B/s each way between two cards (NVLink)
    chips_per_pod: int         # cards of one NVLink domain (one HGX host)
    hbm_bytes: float           # capacity, for fit checks

    def describe(self) -> str:
        return (f"{self.name}: {self.peak_flops_bf16 / 1e12:.0f} TF/s, "
                f"{self.hbm_bw / 1e9:.0f} GB/s HBM, "
                f"{self.link_bw / 1e9:.0f} GB/s NVLink, "
                f"{self.hbm_bytes / 1e9:.0f} GB")


PROFILES: Dict[str, HardwareProfile] = {
    "h100-sxm-80gb": HardwareProfile(
        name="h100-sxm-80gb", peak_flops_bf16=989e12, hbm_bw=3.35e12,
        link_bw=450e9, chips_per_pod=8, hbm_bytes=80e9),
}

DEFAULT_PROFILE = "h100-sxm-80gb"


def get_profile(name: str) -> HardwareProfile:
    try:
        return PROFILES[name]
    except KeyError:
        raise KeyError(f"unknown hardware profile {name!r}; known: "
                       f"{sorted(PROFILES)}") from None


# -- flat constants (the default profile) -----------------------------------
_DEF = PROFILES[DEFAULT_PROFILE]
PEAK_FLOPS_BF16 = _DEF.peak_flops_bf16
HBM_BW = _DEF.hbm_bw
LINK_BW = _DEF.link_bw
CHIPS_PER_POD = _DEF.chips_per_pod
HBM_BYTES = _DEF.hbm_bytes

"""Published peaks, by the name ``torch.cuda.get_device_name()`` gives.

NVIDIA H100 data sheet, dense rates without sparsity, at the full power
limit: SXM part (HBM3) 3.35 TB/s, PCIe part (HBM2e) 2.0 TB/s.  A card set
below its power limit runs slower; the harness prints the card's limit
beside every result.  An unknown device has no peak, and no roofline share
is read on it.
"""

from __future__ import annotations

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12},
    "NVIDIA H100 PCIe": {"hbm_bytes_per_s": 2.0e12},
}


def peak(kind: str | None) -> dict | None:
    return PEAKS.get(kind or "")

"""Published peak rates of the devices the benchmarks divide by.

One table keyed by `jax.Device.device_kind`. A device that is not in the
table is an error, not a default: a roofline share against the wrong peak
is worse than none.

Source of the H100 entry: NVIDIA H100 Tensor Core GPU data sheet, SXM5
part, dense rates (no sparsity), at the full 700 W power limit. A card set
below that limit cannot hold its top clock under a matrix-heavy load, so
report the card's `power.limit` beside any share computed from these.
"""
from __future__ import annotations

__all__ = ["PEAKS", "peaks_for"]

PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "f32_flops": 67e12,       # CUDA cores, no tensor cores
        "tf32_flops": 495e12,     # tensor cores, dense
        "hbm_bytes_per_s": 3.35e12,
        "source": "NVIDIA H100 data sheet (SXM5, dense)",
    },
}


def peaks_for(device_kind: str) -> dict:
    """Peak rates for `device_kind`; raises KeyError for unknown kinds."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise KeyError(
            f"no published peaks for device kind {device_kind!r}; add it to "
            f"bench/peaks.py with its source (known: {sorted(PEAKS)})"
        ) from None

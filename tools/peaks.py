"""Published peak rates per accelerator, keyed by JAX's `device_kind`.

Source: NVIDIA H100 data sheet, SXM part, at its full 700 W power limit
(HBM3 3.35 TB/s; NVLink 900 GB/s total to the other cards = 450 GB/s each
way; dense FP32 67 TFLOP/s outside the tensor cores).  A card set below
700 W reaches less: report its `nvidia-smi` power limit beside any share
of these numbers.  A device missing here is an error, not a default.
"""

from __future__ import annotations

PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "hbm_bytes_per_s": 3.35e12,
        "link_bytes_per_s": 450e9,
        "fp32_flops": 67e12,
    },
}


def peaks(device_kind: str) -> dict:
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise KeyError(
            f"no published peak rates for device {device_kind!r}; add its "
            f"data-sheet values to tools/peaks.py (known: {sorted(PEAKS)})"
        ) from None

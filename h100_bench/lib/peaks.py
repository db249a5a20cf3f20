"""Published peaks of the cards the benchmark runs on.

NVIDIA H100 SXM5 80 GB (NVIDIA's data sheet; dense rates, no sparsity), at
its full 700 W power limit: a card set lower reaches less, and the run prints
the limit beside its numbers.
"""

from __future__ import annotations

PEAKS = {
    "H100": {"bf16_flops": 989e12, "fp16_flops": 989e12, "fp8_flops": 1979e12,
             "tf32_flops": 495e12, "fp32_flops": 67e12, "hbm_bytes_per_s": 3.35e12},
}


def peaks(device_name: str) -> dict:
    for key, p in PEAKS.items():
        if key in device_name:
            return p
    raise KeyError(f"no published peaks for {device_name!r}: add them to lib/peaks.py")


def flops_peak(device_name: str, dtype: str) -> float:
    key = {"bfloat16": "bf16_flops", "float16": "fp16_flops",
           "float32": "fp32_flops"}[dtype]
    return peaks(device_name)[key]

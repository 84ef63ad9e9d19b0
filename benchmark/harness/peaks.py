# -*- coding: utf-8 -*-
"""Published peaks of the cards the benchmark runs on (NVIDIA's data
sheet, H100 SXM, dense, at the 700 W limit): float32 outside the tensor
cores, and HBM3 bandwidth."""

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"flops_f32": 67e12, "hbm_bytes_per_s": 3.35e12},
}


def lookup(kind):
    return PEAKS.get(kind)

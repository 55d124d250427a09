"""Measurement tools for the port's kernels on the card.

The bounds they compute use the H100 SXM's published dense rates (NVIDIA's
data sheet): device memory 3.35 TB/s, tensor cores 495 TFLOP/s in TF32 (an
f32 product on tensor cores) and 989 TFLOP/s in bf16.
"""

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 495e12, "bfloat16": 989e12}

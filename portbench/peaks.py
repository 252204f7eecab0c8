"""Published peaks of one NVIDIA H100 SXM (80 GB HBM3), dense rates, at
its full 700 W power limit (NVIDIA's data sheet). A card set below 700 W
runs slower under load; every run prints the card's limit beside its
numbers.

Products at FP32 grade are priced at the fastest FP32-grade rate the card
offers: three TF32 tensor-core products per FP32 product (3xTF32), a third
of the 495 TFLOP/s TF32 rate. Every other operation (integer, logarithm,
square root, a real add or multiply) is priced as one operation of the
67 TFLOP/s FP32 rate, which counts an FMA as two: an underprice, so a
bound built on it is a lower bound on time.
"""
TF32_FLOPS = 495e12
PRODUCT_FLOPS = TF32_FLOPS / 3          # 3xTF32, FP32-grade products
FP32_FLOPS = 67e12
HBM_BYTES = 3.35e12
POWER_LIMIT_W = 700.0


def bound_seconds(products=0.0, other=0.0, nbytes=0.0) -> float:
    """The least time for the work: the largest of the three units' times
    (they can overlap, so not their sum)."""
    return max(products / PRODUCT_FLOPS, other / FP32_FLOPS,
               nbytes / HBM_BYTES)

"""Peak rates of one NVIDIA H100 SXM (80 GB HBM3), against which the
benchmark states roofline shares.

- HBM bandwidth 3.35 TB/s: NVIDIA's H100 SXM data sheet.
- 32-bit integer multiply-adds, 16.75 T/s: the data sheet's 67 TFLOP/s of
  float32 outside the tensor cores is 132 SMs x 128 lanes x 2 flops x 1.98
  GHz; a 32-bit IMAD issues on half of those lanes, so 132 x 64 x 1.98e9
  multiply-adds a second (a rate measured on the card by the repository's
  own IMAD loop agreed with it).
- A Montgomery product of two 8 x 32-bit BN254 elements: 264 multiply-adds
  (the lo and hi halves of 64 word products for a x b, as many for m x p,
  and 8 for the m words).
Both peaks assume the card's full 700 W power limit.
"""
HBM_BYTES_PER_S = 3.35e12
IMAD_PER_S = 67e12 / 4
MONT_MADS = 264
MIXED_ADD_PRODUCTS = 11      # a mixed Jacobian addition: 7M + 4S
JAC_ADD_PRODUCTS = 16        # a Jacobian addition: 12M + 4S
FIELD_BYTES = 32             # one BN254 element, as 16 x 16-bit limbs


def least_seconds(nbytes: float, mads: float) -> float:
    """The larger of the bytes over the HBM rate and the multiply-adds over
    the IMAD rate."""
    return max(nbytes / HBM_BYTES_PER_S, mads / IMAD_PER_S)

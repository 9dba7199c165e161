"""The card's peaks that the rooflines are read against (NVIDIA H100 SXM).

HBM: 3.35e12 B/s, NVIDIA's published figure for the H100 SXM.
IMAD: 32-bit integer multiply-adds, 64 per SM per clock (half the fp32 FMA
rate behind the published 67 TFLOP/s fp32 figure), at the published 132 SMs
and 1.98 GHz boost clock: 16.7e12/s. Derived, not measured. A Montgomery
product of N 32-bit limbs (CIOS) takes 2 (2 N^2) + N IMADs: a 32 x 32 ->
64-bit limb product is 2 IMADs (low and high halves), a low-half one 1.
Both figures assume the card's full 700 W; the run prints the card's power
limit beside them.
"""

HBM_BYTES_PER_S = 3.35e12
IMAD_PER_S = 132 * 64 * 1.98e9
FP_LIMBS = 12
FR_LIMBS = 8


def mont_mul_imad(nlimbs: int) -> int:
    return 2 * (2 * nlimbs * nlimbs) + nlimbs


def least_seconds(imad: float, nbytes: float) -> tuple[float, str]:
    """The least time the card needs for the work, and which peak bounds it."""
    t_ops, t_bytes = imad / IMAD_PER_S, nbytes / HBM_BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")

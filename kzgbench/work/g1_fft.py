"""The work of the G1 transforms in one call of the FK20 prover.

A frozen copy of chip_smoke.py's `g1_fft_products`: an n-point transform
over G1 is n/2 butterflies a stage (2 additions each, 12 Montgomery
products an addition) and, in stages 1..log n - 1, one multiplication by a
twiddle a butterfly: a GLV ladder of the product by beta, a table of 2
doublings (8 products each) and 14 additions, and 65 steps of 2 doublings
and 1 addition. The count follows from the transform's size alone.

The prover runs two transforms of n = 2 poly_len / cell_size points per
blob: the inverse circulant one over the slots and the one that makes the
proofs. Bytes: each row's points in and out, Jacobian (3 x 48 B).
"""

from kzgbench.peaks import FP_LIMBS, mont_mul_imad

DBL_PRODUCTS, ADD_PRODUCTS = 8, 12
GLV_STEPS = 65


def ladder_products() -> int:
    return 1 + 2 * DBL_PRODUCTS + 14 * ADD_PRODUCTS + GLV_STEPS * (2 * DBL_PRODUCTS + ADD_PRODUCTS)


def products(n: int) -> int:
    log_n = n.bit_length() - 1
    return (n // 2) * (log_n * 2 * ADD_PRODUCTS + (log_n - 1) * ladder_products())


def work(shapes: dict):
    """(IMADs, bytes) of one call's G1 transforms, or None if it runs none."""
    blobs = shapes.get("fk20_blobs")
    if not blobs:
        return None
    n = 2 * shapes["poly_len"] // shapes["cell_size"]
    rows = 2 * blobs
    return rows * products(n) * mont_mul_imad(FP_LIMBS), rows * 2 * 3 * 48 * n

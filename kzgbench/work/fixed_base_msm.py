"""The work of the fixed-base MSMs in one call of the FK20 prover.

The prover's one fixed-base MSM a call sums, for each of the blob's
2 poly_len / cell_size proof slots, cell_size scalars against that slot's
points, through window tables of width w (the configuration's precomp
width): signed w-bit digits, `chains` runs of wpc windows each (the table
holds the points pre-scaled by 2^(w wpc j) for chain j), a halving tree
over the chains x points lanes of one window (a chord level of affine
additions, 8 products, pairing lane j with j + half, then additions of 12),
and a Horner loop of (wpc - 1) steps of w doublings (8) and one addition
(12) a slot; one Fr product a scalar to standard form.

A frozen copy of chip_smoke.py's `fixed_base_msm_work`, with one change:
that function counts the live lanes (a nonzero digit) of the scalars it is
given; here the count is what uniform scalars below r need in expectation,
from the shapes alone (the scalars are the prover's own, out of sight). The
tree's additions that find both operands live are counted in expectation
the same way. Bytes: 96 B a live entry read, the scalars, the identity
mask and the output points.
"""

from kzgbench.peaks import FP_LIMBS, FR_LIMBS, mont_mul_imad

R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
SCALAR_BITS = 256
CHAINS = 4
CHORD_PRODUCTS, ADD_PRODUCTS, DBL_PRODUCTS = 8, 12, 8


def digit_live_share(window: int) -> list[float]:
    """P(signed digit t != 0) for a uniform scalar below r, t = 0..n_win-1.
    A digit is u_t + carry, less 2^w where that exceeds 2^(w-1), so it is
    zero when u_t + carry is 0 or 2^w: 1 / 2^w for a full window (the carry
    is 1 about half the time). The window that holds r's top bit takes
    u_t <= r >> lo, too few values to wrap, so only u_t = 0 with no carry
    makes it zero; the windows above it hold that window's carry, always 0."""
    n_win = SCALAR_BITS // window + 1
    top = R.bit_length()
    out = []
    for t in range(n_win):
        lo = t * window
        if lo >= top:
            out.append(0.0)
        elif lo + window >= top:
            span = (R >> lo) + 1
            if span > 1 << (window - 1):
                raise ValueError(f"window {window}: r's top window wraps; count it")
            out.append(1.0 - 0.5 / span)
        else:
            out.append(1.0 - 1.0 / (1 << window))
    return out


def _tree(shares: list[float]) -> tuple[float, float]:
    """Expected additions with both operands live in a halving tree over
    lanes live with the given probabilities; and the live share of the sum."""
    adds = 0.0
    level = list(shares)
    while len(level) > 1:
        h = len(level) // 2
        adds += sum(a * b for a, b in zip(level[:h], level[h:]))
        level = [1 - (1 - a) * (1 - b) for a, b in zip(level[:h], level[h:])]
    return adds, level[0]


def counts(n_out: int, points: int, window: int, instances: int = 1, chains: int = CHAINS) -> dict:
    """Expected products, IMADs and bytes of n_out sums of `points` scalars
    each, over the tables of `instances` point sets."""
    n_win = SCALAR_BITS // window + 1
    wpc = -(-n_win // chains)
    live_t = digit_live_share(window) + [0.0] * (chains * wpc - n_win)
    lanes = chains * points
    chord, m = (1, lanes // 2) if lanes % 2 == 0 and lanes > 1 else (0, lanes)
    size = 1 << max(m - 1, 0).bit_length()
    chord_adds = tree_adds = live_entries = 0.0
    for t in range(wpc):
        lane = [live_t[c * wpc + t] for c in range(chains) for _ in range(points)]
        live_entries += sum(lane)
        if chord:
            chord_adds += sum(a * b for a, b in zip(lane[:m], lane[m:]))
            lane = [1 - (1 - a) * (1 - b) for a, b in zip(lane[:m], lane[m:])]
        adds, _ = _tree(lane + [0.0] * (size - len(lane)))
        tree_adds += adds
    horner = (wpc - 1) * (window * DBL_PRODUCTS + ADD_PRODUCTS)
    fp_products = n_out * (chord_adds * CHORD_PRODUCTS + tree_adds * ADD_PRODUCTS + horner)
    n_scalars = n_out * points
    return {
        "live_entries": n_out * live_entries, "fp_products": fp_products,
        "imad": fp_products * mont_mul_imad(FP_LIMBS) + n_scalars * mont_mul_imad(FR_LIMBS),
        "bytes": 96 * n_out * live_entries + 32 * n_scalars + instances * lanes + 3 * 48 * n_out,
    }


def work(shapes: dict):
    """(IMADs, bytes) of one call's fixed-base MSMs, or None if it runs none."""
    blobs = shapes.get("fk20_blobs")
    if not blobs:
        return None
    slots = 2 * shapes["poly_len"] // shapes["cell_size"]
    c = counts(blobs * slots, shapes["cell_size"], shapes["window"], instances=slots)
    return c["imad"], c["bytes"]

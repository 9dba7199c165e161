"""Seeded inputs at the edges of the kernels' contracts, for checks.

Shared by the card tests (`tests/test_torch_kernels_cuda.py`), the CPU tests
and `chip_smoke.py`: Montgomery-product operand pairs at the bounds of
`mont_mul`'s contract, compressed G1 points of every kind the
decompression meets (subgroup points of both signs, the identity, x off
the curve, curve points outside the subgroup), and MSM scalars with zero,
r - 1 and all-zero rows. Host Python and numpy only.
"""

from __future__ import annotations

import random

import numpy as np

from ..constants import P, R_SCALAR
from ..ops.decompress import parse_compressed_g1_batch
from ..ops.field import FR
from . import bls_host as B


def edge_operands(spec, seed=17, n_random=64):
    """Montgomery-product operand pairs at the edges of the contract a < 2m,
    b < m: a in {0, 1, R mod m, m - 1, m, 2m - 1}, b in {0, 1, m - 1}, the
    all-ones limb patterns 2^(32 k) - 1 below each bound, and `n_random`
    random pairs. Returns (a list, b list) of ints."""
    m = spec.modulus
    ones = [(1 << (32 * k)) - 1 for k in range(1, spec.nlimbs + 1)]
    a_edge = [0, 1, spec.r_mod_p, m - 1, m, 2 * m - 1] + [v for v in ones if v < 2 * m]
    b_edge = [0, 1, m - 1] + [v for v in ones if v < m]
    pairs = [(a, b) for a in a_edge for b in b_edge]
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 2**32, size=(n_random, 2, 2 * spec.nlimbs), dtype=np.uint64)
    for row in words:
        a, b = (int.from_bytes(w.astype("<u4").tobytes(), "little") for w in row)
        pairs.append((a % (2 * m), b % m))
    return [a for a, _ in pairs], [b for _, b in pairs]


def inverse_edge_values(spec) -> list:
    """Nonzero field elements (ints below m) at the edges of the binary GCD of
    the `batch_inverse` kernel: 1, 2, m - 1, m - 2, (m + 1) / 2, 2^380 mod m,
    R mod m (whose Montgomery form is R^2 mod m), powers of two and their
    neighbours, and m - 2^k."""
    m = spec.modulus
    vals = [1, 2, m - 1, m - 2, (m + 1) // 2, pow(2, 380, m), spec.r_mod_p]
    vals += [(1 << k) % m for k in (31, 32, 63, 64, 65, 127, 254, 255, 381)]
    vals += [((1 << k) - 1) % m for k in (31, 33, 64, 96, 255)]
    vals += [m - (1 << k) for k in (0, 31, 32, 64, 200)]
    return list(dict.fromkeys(v for v in vals if v))


def off_curve_bytes(rnd: random.Random) -> bytes:
    """Compressed bytes of an x with no point on the curve."""
    while True:
        x = rnd.randrange(P)
        if B.fp_sqrt(x * x * x + 4) is None:
            data = bytearray(x.to_bytes(48, "big"))
            data[0] |= 0x80
            return bytes(data)


def not_in_subgroup_bytes(rnd: random.Random) -> bytes:
    """Compressed bytes of a curve point outside the prime-order subgroup."""
    while True:
        x = rnd.randrange(P)
        y = B.fp_sqrt(x * x * x + 4)
        if y is not None and not B.g1_in_subgroup((x, y)):
            return B.g1_compress((x, y))


def decompress_inputs(n, seed):
    """n compressed G1 points for the decompression kernel: subgroup points
    and their negations (both sort bits), identity lanes, x off the curve
    and curve points outside the subgroup. Returns the parser's
    (x_std, sort_bits, inf) and the kinds of the lanes."""
    rnd = random.Random(seed)
    base = [B.g1_mul(B.G1_GEN, rnd.randrange(1, 2**64)) for _ in range(8)]
    good = [B.g1_compress(p) for p in base] + [B.g1_compress((x, P - y)) for x, y in base]
    specials = {"identity": [B.g1_compress(None)], "off_curve": [off_curve_bytes(rnd) for _ in range(3)],
                "not_in_subgroup": [not_in_subgroup_bytes(rnd) for _ in range(3)]}
    raw, kinds = [], []
    for i in range(n):
        kind = ("identity", "off_curve", "not_in_subgroup")[i % 3] if i % 5 == 2 else "good"
        pool = good if kind == "good" else specials[kind]
        raw.append(pool[rnd.randrange(len(pool))])
        kinds.append(kind)
    return parse_compressed_g1_batch(raw), kinds


def msm_scalars(shape, seed, edges: bool = True) -> np.ndarray:
    """Montgomery Fr limbs [8, *shape] int32 of scalars for a fixed-base MSM
    check: random below r; with `edges` every 7th lane 0, every 11th (from
    lane 3) r - 1, and the whole first row 0 where the leading axis has more
    than one row and there is a point axis behind it."""
    shape = tuple(shape)
    n = int(np.prod(shape))
    words = np.random.default_rng(seed).integers(0, 2**32, size=(n, 8), dtype=np.uint64)
    raw = words.astype("<u4").tobytes()
    vals = [int.from_bytes(raw[32 * i : 32 * (i + 1)], "little") % R_SCALAR for i in range(n)]
    if not edges:
        return FR.to_mont_host(vals).reshape((FR.nlimbs,) + shape)
    vals[::7] = [0] * len(vals[::7])
    vals[3::11] = [R_SCALAR - 1] * len(vals[3::11])
    if len(shape) > 1 and shape[0] > 1:
        row = n // shape[0]
        vals[:row] = [0] * row
    return FR.to_mont_host(vals).reshape((FR.nlimbs,) + shape)

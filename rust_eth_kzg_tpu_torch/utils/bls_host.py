"""Host-side BLS12-381 arithmetic over Python integers.

The control-plane counterpart of the device kernels: G1 and G2 point
compression and decompression, the Fp2 / Fp6 / Fp12 tower and the ate
pairing, and the oracle the device results are checked against. G1 points
are affine (x, y) tuples of ints, G2 points affine tuples of Fp2 pairs, and
None is the identity.

The pairing here is the tests' oracle for the native library
(`utils/native.py`); the verifier calls the native one only.
"""

from __future__ import annotations

from ..constants import BLS_X, B_COEFF, G1_GEN_X, G1_GEN_Y, G2_GEN_X, G2_GEN_Y, P, R_SCALAR

_P_MINUS_2 = P - 2
_SQRT_EXP = (P + 1) // 4  # valid since p % 4 == 3


def fp_sqrt(a: int) -> int | None:
    """Square root in Fp, or None if `a` is not a quadratic residue."""
    a %= P
    r = pow(a, _SQRT_EXP, P)
    return r if r * r % P == a else None


G1_GEN = (G1_GEN_X, G1_GEN_Y)


def g1_is_on_curve(pt) -> bool:
    if pt is None:
        return True
    x, y = pt
    return (y * y - x * x * x - B_COEFF) % P == 0


def g1_neg(pt):
    return None if pt is None else (pt[0], -pt[1] % P)


def g1_add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if (y1 + y2) % P == 0:
            return None
        m = 3 * x1 * x1 * pow(2 * y1, _P_MINUS_2, P) % P
    else:
        m = (y2 - y1) * pow(x2 - x1, _P_MINUS_2, P) % P
    x3 = (m * m - x1 - x2) % P
    y3 = (m * (x1 - x3) - y1) % P
    return (x3, y3)


def g1_double(pt):
    return g1_add(pt, pt)


def g1_mul_unreduced(pt, k: int):
    """Double-and-add without reducing k mod r (for subgroup checks)."""
    result = None
    add_end = pt
    while k > 0:
        if k & 1:
            result = g1_add(result, add_end)
        add_end = g1_add(add_end, add_end)
        k >>= 1
    return result


def g1_mul(pt, k: int):
    return g1_mul_unreduced(pt, k % R_SCALAR)


def g1_in_subgroup(pt) -> bool:
    return g1_is_on_curve(pt) and g1_mul_unreduced(pt, R_SCALAR) is None


# --- point compression (ZCash / blst convention: 3 flag bits in the MSB) ---


def _y_sign(y: int) -> bool:
    return y * 2 > P


def g1_compress(pt) -> bytes:
    if pt is None:
        return bytes([0xC0]) + bytes(47)
    x, y = pt
    data = bytearray(x.to_bytes(48, "big"))
    data[0] |= 0x80
    if _y_sign(y):
        data[0] |= 0x20
    return bytes(data)


def g1_decompress(data: bytes, subgroup_check: bool = True):
    """Returns an affine point / None (identity), or raises ValueError."""
    if len(data) != 48:
        raise ValueError(f"G1 point must be 48 bytes, got {len(data)}")
    c_flag = data[0] & 0x80
    i_flag = data[0] & 0x40
    s_flag = data[0] & 0x20
    if not c_flag:
        raise ValueError("uncompressed G1 encodings are not accepted")
    body = bytes([data[0] & 0x1F]) + data[1:]
    if i_flag:
        if s_flag or any(body):
            raise ValueError("invalid infinity encoding")
        return None
    x = int.from_bytes(body, "big")
    if x >= P:
        raise ValueError("G1 x coordinate not canonical")
    y = fp_sqrt((x * x % P * x + B_COEFF) % P)
    if y is None:
        raise ValueError("G1 x coordinate not on curve")
    if _y_sign(y) != bool(s_flag):
        y = P - y
    pt = (x, y)
    if subgroup_check and not g1_in_subgroup(pt):
        raise ValueError("G1 point not in the prime-order subgroup")
    return pt


# ---------------------------------------------------------------------------
# Fp2 = Fp[u] / (u^2 + 1)
# ---------------------------------------------------------------------------

FP2_ZERO = (0, 0)
FP2_ONE = (1, 0)
XI = (1, 1)  # sextic twist nonresidue xi = 1 + u


def fp2_add(x, y):
    return ((x[0] + y[0]) % P, (x[1] + y[1]) % P)


def fp2_sub(x, y):
    return ((x[0] - y[0]) % P, (x[1] - y[1]) % P)


def fp2_neg(x):
    return (-x[0] % P, -x[1] % P)


def fp2_conj(x):
    return (x[0], -x[1] % P)


def fp2_mul(x, y):
    a, b = x
    c, d = y
    ac = a * c
    bd = b * d
    return ((ac - bd) % P, ((a + b) * (c + d) - ac - bd) % P)


def fp2_sqr(x):
    a, b = x
    return ((a + b) * (a - b) % P, 2 * a * b % P)


def fp2_muls(x, s: int):
    return (x[0] * s % P, x[1] * s % P)


def fp2_inv(x):
    a, b = x
    d = pow(a * a + b * b, _P_MINUS_2, P)
    return (a * d % P, -b * d % P)


def fp2_pow(x, e: int):
    result = FP2_ONE
    base = x
    while e > 0:
        if e & 1:
            result = fp2_mul(result, base)
        base = fp2_sqr(base)
        e >>= 1
    return result


def fp2_sqrt(a):
    """Square root in Fp2 (p % 4 == 3), or None if not a QR.

    Algorithm 9 of https://eprint.iacr.org/2012/685; the final squaring check
    makes the routine self-verifying.
    """
    if a == FP2_ZERO:
        return FP2_ZERO
    a1 = fp2_pow(a, (P - 3) // 4)
    x0 = fp2_mul(a1, a)
    alpha = fp2_mul(a1, x0)
    if alpha == (P - 1, 0):
        x = (-x0[1] % P, x0[0])
    else:
        b = fp2_pow(fp2_add(alpha, FP2_ONE), (P - 1) // 2)
        x = fp2_mul(b, x0)
    return x if fp2_sqr(x) == a else None


# ---------------------------------------------------------------------------
# Fp6 = Fp2[v] / (v^3 - xi),  Fp12 = Fp6[w] / (w^2 - v)
# ---------------------------------------------------------------------------

FP6_ZERO = (FP2_ZERO, FP2_ZERO, FP2_ZERO)
FP6_ONE = (FP2_ONE, FP2_ZERO, FP2_ZERO)


def _mul_by_xi(x):
    # (a + bu)(1 + u) = (a - b) + (a + b)u
    a, b = x
    return ((a - b) % P, (a + b) % P)


def fp6_add(x, y):
    return tuple(fp2_add(a, b) for a, b in zip(x, y))


def fp6_sub(x, y):
    return tuple(fp2_sub(a, b) for a, b in zip(x, y))


def fp6_neg(x):
    return tuple(fp2_neg(a) for a in x)


def fp6_mul(x, y):
    a0, a1, a2 = x
    b0, b1, b2 = y
    t00 = fp2_mul(a0, b0)
    t11 = fp2_mul(a1, b1)
    t22 = fp2_mul(a2, b2)
    c0 = fp2_add(t00, _mul_by_xi(fp2_add(fp2_mul(a1, b2), fp2_mul(a2, b1))))
    c1 = fp2_add(fp2_add(fp2_mul(a0, b1), fp2_mul(a1, b0)), _mul_by_xi(t22))
    c2 = fp2_add(fp2_add(fp2_mul(a0, b2), fp2_mul(a2, b0)), t11)
    return (c0, c1, c2)


def fp6_mul_by_v(x):
    # v * (c0 + c1 v + c2 v^2) = xi*c2 + c0 v + c1 v^2
    c0, c1, c2 = x
    return (_mul_by_xi(c2), c0, c1)


def fp6_inv(x):
    c0, c1, c2 = x
    t0 = fp2_sub(fp2_sqr(c0), _mul_by_xi(fp2_mul(c1, c2)))
    t1 = fp2_sub(_mul_by_xi(fp2_sqr(c2)), fp2_mul(c0, c1))
    t2 = fp2_sub(fp2_sqr(c1), fp2_mul(c0, c2))
    d = fp2_add(
        fp2_mul(c0, t0),
        _mul_by_xi(fp2_add(fp2_mul(c2, t1), fp2_mul(c1, t2))),
    )
    d_inv = fp2_inv(d)
    return (fp2_mul(t0, d_inv), fp2_mul(t1, d_inv), fp2_mul(t2, d_inv))


FP12_ZERO = (FP6_ZERO, FP6_ZERO)
FP12_ONE = (FP6_ONE, FP6_ZERO)


def fp12_add(x, y):
    return (fp6_add(x[0], y[0]), fp6_add(x[1], y[1]))


def fp12_sub(x, y):
    return (fp6_sub(x[0], y[0]), fp6_sub(x[1], y[1]))


def fp12_neg(x):
    return (fp6_neg(x[0]), fp6_neg(x[1]))


def fp12_mul(x, y):
    a, b = x
    c, d = y
    ac = fp6_mul(a, c)
    bd = fp6_mul(b, d)
    return (
        fp6_add(ac, fp6_mul_by_v(bd)),
        fp6_sub(fp6_sub(fp6_mul(fp6_add(a, b), fp6_add(c, d)), ac), bd),
    )


def fp12_sqr(x):
    return fp12_mul(x, x)


def fp12_conj(x):
    """Conjugation a + bw -> a - bw, i.e. the p^6 Frobenius."""
    return (x[0], fp6_neg(x[1]))


def fp12_inv(x):
    a, b = x
    d = fp6_sub(fp6_mul(a, a), fp6_mul_by_v(fp6_mul(b, b)))
    d_inv = fp6_inv(d)
    return (fp6_mul(a, d_inv), fp6_neg(fp6_mul(b, d_inv)))


def fp12_pow(x, e: int):
    result = FP12_ONE
    base = x
    while e > 0:
        if e & 1:
            result = fp12_mul(result, base)
        base = fp12_sqr(base)
        e >>= 1
    return result


def fp12_from_fp(a: int):
    return (((a % P, 0), FP2_ZERO, FP2_ZERO), FP6_ZERO)


# Frobenius on Fp12 in the w-basis: f = sum c_i w^i with c_i in Fp2 and
# w^6 = xi, so f^p = sum conj(c_i) * gamma^i * w^i with gamma = xi^((p-1)/6).
_GAMMA = fp2_pow(XI, (P - 1) // 6)
_GAMMA_POWS = [FP2_ONE]
for _ in range(5):
    _GAMMA_POWS.append(fp2_mul(_GAMMA_POWS[-1], _GAMMA))


def _fp12_to_wbasis(x):
    (a0, a1, a2), (b0, b1, b2) = x
    return [a0, b0, a1, b1, a2, b2]


def _fp12_from_wbasis(c):
    return ((c[0], c[2], c[4]), (c[1], c[3], c[5]))


def fp12_frobenius(x):
    c = _fp12_to_wbasis(x)
    c = [fp2_mul(fp2_conj(ci), g) for ci, g in zip(c, _GAMMA_POWS)]
    return _fp12_from_wbasis(c)


# ---------------------------------------------------------------------------
# G2: y^2 = x^3 + 4(u+1) over Fp2. Affine ((x0,x1),(y0,y1)) or None.
# ---------------------------------------------------------------------------

G2_GEN = (G2_GEN_X, G2_GEN_Y)
B2_COEFF = (4, 4)  # 4 * (1 + u)


def g2_is_on_curve(pt) -> bool:
    if pt is None:
        return True
    x, y = pt
    return fp2_sqr(y) == fp2_add(fp2_mul(fp2_sqr(x), x), B2_COEFF)


def g2_neg(pt):
    return None if pt is None else (pt[0], fp2_neg(pt[1]))


def g2_add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if fp2_add(y1, y2) == FP2_ZERO:
            return None
        m = fp2_mul(fp2_muls(fp2_sqr(x1), 3), fp2_inv(fp2_muls(y1, 2)))
    else:
        m = fp2_mul(fp2_sub(y2, y1), fp2_inv(fp2_sub(x2, x1)))
    x3 = fp2_sub(fp2_sub(fp2_sqr(m), x1), x2)
    y3 = fp2_sub(fp2_mul(m, fp2_sub(x1, x3)), y1)
    return (x3, y3)


def g2_mul(pt, k: int):
    k %= R_SCALAR
    result = None
    add_end = pt
    while k > 0:
        if k & 1:
            result = g2_add(result, add_end)
        add_end = g2_add(add_end, add_end)
        k >>= 1
    return result


def g2_mul_unreduced(pt, k: int):
    result = None
    add_end = pt
    while k > 0:
        if k & 1:
            result = g2_add(result, add_end)
        add_end = g2_add(add_end, add_end)
        k >>= 1
    return result


def g2_in_subgroup(pt) -> bool:
    return g2_is_on_curve(pt) and g2_mul_unreduced(pt, R_SCALAR) is None


def _fp2_sign(y) -> bool:
    # lexicographic comparison of (c1, c0) vs its negation
    if y[1] != 0:
        return y[1] * 2 > P
    return y[0] * 2 > P


def g2_compress(pt) -> bytes:
    if pt is None:
        return bytes([0xC0]) + bytes(95)
    (x0, x1), y = pt
    data = bytearray(x1.to_bytes(48, "big") + x0.to_bytes(48, "big"))
    data[0] |= 0x80
    if _fp2_sign(y):
        data[0] |= 0x20
    return bytes(data)


def g2_decompress(data: bytes, subgroup_check: bool = True):
    if len(data) != 96:
        raise ValueError(f"G2 point must be 96 bytes, got {len(data)}")
    c_flag = data[0] & 0x80
    i_flag = data[0] & 0x40
    s_flag = data[0] & 0x20
    if not c_flag:
        raise ValueError("uncompressed G2 encodings are not accepted")
    body = bytes([data[0] & 0x1F]) + data[1:]
    if i_flag:
        if s_flag or any(body):
            raise ValueError("invalid infinity encoding")
        return None
    x1 = int.from_bytes(body[:48], "big")
    x0 = int.from_bytes(body[48:], "big")
    if x0 >= P or x1 >= P:
        raise ValueError("G2 x coordinate not canonical")
    x = (x0, x1)
    y = fp2_sqrt(fp2_add(fp2_mul(fp2_sqr(x), x), B2_COEFF))
    if y is None:
        raise ValueError("G2 x coordinate not on curve")
    if _fp2_sign(y) != bool(s_flag):
        y = fp2_neg(y)
    pt = (x, y)
    if subgroup_check and not g2_in_subgroup(pt):
        raise ValueError("G2 point not in the prime-order subgroup")
    return pt


# ---------------------------------------------------------------------------
# Pairing. Ate pairing with affine Miller loop over points embedded in
# E(Fp12) via the untwist map; correctness is anchored by bilinearity tests
# and the consensus-spec verification vectors.
# ---------------------------------------------------------------------------

# w^6 = xi, untwist (x', y') -> (x'/w^2, y'/w^3)
# w^2 = v (an Fp12 element with 1*v in the first Fp6 component); w^3 = v*w.
_W2 = ((FP2_ZERO, FP2_ONE, FP2_ZERO), FP6_ZERO)
_W3 = (FP6_ZERO, (FP2_ZERO, FP2_ONE, FP2_ZERO))
_W2_INV = fp12_inv(_W2)
_W3_INV = fp12_inv(_W3)


def _embed_fp2(x):
    return ((x, FP2_ZERO, FP2_ZERO), FP6_ZERO)


def _untwist(pt):
    x, y = pt
    return (
        fp12_mul(_embed_fp2(x), _W2_INV),
        fp12_mul(_embed_fp2(y), _W3_INV),
    )


def _line(a, b, pt):
    """Evaluate the line through Fp12-points a, b at pt (all affine, non-inf)."""
    ax, ay = a
    bx, by = b
    px, py = pt
    if ax != bx:
        m = fp12_mul(fp12_sub(by, ay), fp12_inv(fp12_sub(bx, ax)))
    elif ay == by:
        m = fp12_mul(
            fp12_mul(fp12_sqr(ax), fp12_from_fp(3)),
            fp12_inv(fp12_mul(ay, fp12_from_fp(2))),
        )
    else:
        return fp12_sub(px, ax)
    return fp12_sub(fp12_sub(py, ay), fp12_mul(m, fp12_sub(px, ax)))


def _fp12_pt_add(p1, p2):
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2 and y1 == y2:
        m = fp12_mul(
            fp12_mul(fp12_sqr(x1), fp12_from_fp(3)),
            fp12_inv(fp12_mul(y1, fp12_from_fp(2))),
        )
    else:
        m = fp12_mul(fp12_sub(y2, y1), fp12_inv(fp12_sub(x2, x1)))
    x3 = fp12_sub(fp12_sub(fp12_sqr(m), x1), x2)
    y3 = fp12_sub(fp12_mul(m, fp12_sub(x1, x3)), y1)
    return (x3, y3)


def miller_loop(p1, q2):
    """Miller loop f_{|z|,Q}(P) for P in G1, Q in G2 (both affine, non-identity)."""
    p_emb = (fp12_from_fp(p1[0]), fp12_from_fp(p1[1]))
    q_emb = _untwist(q2)
    f = FP12_ONE
    t = q_emb
    for bit in bin(BLS_X)[3:]:
        f = fp12_mul(fp12_sqr(f), _line(t, t, p_emb))
        t = _fp12_pt_add(t, t)
        if bit == "1":
            f = fp12_mul(f, _line(t, q_emb, p_emb))
            t = _fp12_pt_add(t, q_emb)
    # z < 0: f_{z} = conj(f_{|z|}) up to factors killed by the final exponentiation
    return fp12_conj(f)


_HARD_EXP = (P**4 - P**2 + 1) // R_SCALAR


def final_exponentiation(f):
    # easy part: f^((p^6 - 1)(p^2 + 1))
    f = fp12_mul(fp12_conj(f), fp12_inv(f))
    f = fp12_mul(fp12_frobenius(fp12_frobenius(f)), f)
    # hard part: f^((p^4 - p^2 + 1) / r)
    return fp12_pow(f, _HARD_EXP)


def pairing(p1, q2):
    """Full ate pairing e(P, Q). Identity inputs map to Fp12 one."""
    if p1 is None or q2 is None:
        return FP12_ONE
    return final_exponentiation(miller_loop(p1, q2))


def multi_pairings(pairs) -> bool:
    """Checks prod e(P_i, Q_i) == 1 with a single final exponentiation.

    Mirrors the reference's `multi_pairings` (bls12_381 crate, lib.rs).
    """
    f = FP12_ONE
    for p1, q2 in pairs:
        if p1 is None or q2 is None:
            continue
        f = fp12_mul(f, miller_loop(p1, q2))
    return final_exponentiation(f) == FP12_ONE


def reduce_bytes_to_scalar(data: bytes) -> int:
    """256-bit big-endian bytes reduced mod r.

    Matches the reference's `reduce_bytes_to_scalar_bias` (bls12_381 crate).
    """
    return int.from_bytes(data, "big") % R_SCALAR

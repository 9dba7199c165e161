"""Host oracle over Python ints: polynomial helpers and the naive multi-open.

A from-first-principles BDFG multi-point opening over an insecure setup
whose tau is known, so quotient commitments are single scalar
multiplications [q(tau)] G. Independent of the device code.
"""

from __future__ import annotations

from ..constants import R_SCALAR
from ..utils import bls_host as bls


def insecure_setup(num_g1: int, num_g2: int, tau: int = 1234567):
    """Monomial SRS [tau^i] G1 and [tau^i] G2 with known tau (test-only);
    returns (g1 points, g2 points, tau). Each point is tau times the last,
    a short scalar multiplication for a small tau."""
    g1s = [bls.G1_GEN][:num_g1]
    while len(g1s) < num_g1:
        g1s.append(bls.g1_mul(g1s[-1], tau))
    g2s = [bls.G2_GEN][:num_g2]
    while len(g2s) < num_g2:
        g2s.append(bls.g2_mul(g2s[-1], tau))
    return g1s, g2s, tau


def poly_eval_host(coeffs: list[int], x: int) -> int:
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % R_SCALAR
    return acc


def vanishing_poly_host(roots: list[int]) -> list[int]:
    """Monic polynomial with the given roots (coefficients, lowest first)."""
    coeffs = [1]
    for r in roots:
        nxt = [0] * (len(coeffs) + 1)
        for i, c in enumerate(coeffs):
            nxt[i] = (nxt[i] - c * r) % R_SCALAR
            nxt[i + 1] = (nxt[i + 1] + c) % R_SCALAR
        coeffs = nxt
    return coeffs


def lagrange_interpolate_host(xs: list[int], ys: list[int]) -> list[int]:
    """O(n^2) Lagrange interpolation (oracle grade)."""
    n = len(xs)
    coeffs = [0] * n
    for i in range(n):
        num = [1]
        denom = 1
        for j in range(n):
            if j == i:
                continue
            nxt = [0] * (len(num) + 1)
            for k, c in enumerate(num):
                nxt[k] = (nxt[k] - c * xs[j]) % R_SCALAR
                nxt[k + 1] = (nxt[k + 1] + c) % R_SCALAR
            num = nxt
            denom = denom * (xs[i] - xs[j]) % R_SCALAR
        scale = ys[i] * pow(denom, R_SCALAR - 2, R_SCALAR) % R_SCALAR
        for k, c in enumerate(num):
            coeffs[k] = (coeffs[k] + c * scale) % R_SCALAR
    return coeffs


def poly_divide_exact(num: list[int], den: list[int]) -> list[int]:
    """Exact polynomial division num / den over Fr (the remainder must be 0)."""
    num = [c % R_SCALAR for c in num]
    dn = len(den) - 1
    while len(num) > 1 and num[-1] == 0:
        num.pop()
    q = [0] * max(len(num) - dn, 0)
    inv_lead = pow(den[-1], R_SCALAR - 2, R_SCALAR)
    for i in range(len(q) - 1, -1, -1):
        coeff = num[i + dn] * inv_lead % R_SCALAR
        q[i] = coeff
        for j, d in enumerate(den):
            num[i + j] = (num[i + j] - coeff * d) % R_SCALAR
    if any(num):
        raise ArithmeticError("polynomial division had a remainder")
    return q


def compute_multi_opening_naive(poly: list[int], input_points: list[int], tau: int):
    """BDFG multi-point opening: ([q(tau)] G, evaluations at the points)."""
    ys = [poly_eval_host(poly, x) for x in input_points]
    interp = lagrange_interpolate_host(input_points, ys)
    numerator = list(poly)
    for i, c in enumerate(interp):
        numerator[i] = (numerator[i] - c) % R_SCALAR
    quotient = poly_divide_exact(numerator, vanishing_poly_host(input_points))
    return bls.g1_mul(bls.G1_GEN, poly_eval_host(quotient, tau)), ys


def commit_with_tau(poly: list[int], tau: int):
    """[p(tau)] G, the commitment of `poly` under the insecure setup."""
    return bls.g1_mul(bls.G1_GEN, poly_eval_host(poly, tau))


def ntt_host(values: list[int], root: int) -> list[int]:
    """Evaluations sum_j values[j] root^(i j), i < n (radix-2, n a power of two)."""
    n = len(values)
    if n == 1:
        return list(values)
    even = ntt_host(values[0::2], root * root % R_SCALAR)
    odd = ntt_host(values[1::2], root * root % R_SCALAR)
    out = [0] * n
    w = 1
    for i in range(n // 2):
        t = w * odd[i] % R_SCALAR
        out[i] = (even[i] + t) % R_SCALAR
        out[i + n // 2] = (even[i] - t) % R_SCALAR
        w = w * root % R_SCALAR
    return out

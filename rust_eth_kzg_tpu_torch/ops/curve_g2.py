"""Batched G2 arithmetic on torch tensors: the Fp2 tower and complete
projective formulas.

The counterpart of rust_eth_kzg_tpu/ops/curve_g2.py, the device form of the
reference's `g2_lincomb` (size 65 in the JAX package's bench). An Fp2
element is a pair (c0, c1) of [12, *batch] Montgomery Fp limb tensors,
c0 + c1 u with u^2 = -1; a G2 point is three of them, (X : Y : Z), with the
identity (0 : 1 : 0). The curve is y^2 = x^3 + 4 (1 + u), and the addition
and doubling are the Renes-Costello-Batina complete formulas with a = 0, as
for G1 (ops/curve.py). Every value is fully reduced (ops/field.py), so the
JAX module's lazy bounds and canonicalisations have no counterpart here.

Every Fp product goes through `field.mont_mul`: the `mont_mul` kernel on
CUDA tensors, `mont_mul_plain` on CPU tensors. The independent products of
one step of `add` and `double` are stacked into one call, as the plain G1
formulas of ops/curve.py stack theirs; additions and subtractions are the
plain torch operations of ops/field.py. No G1 kernel runs here.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..constants import P
from . import field as F
from . import msm as M

FP = F.FP
B3 = 12  # 3 b' = 12 (1 + u) for b' = 4 (1 + u): both components of 3 b' are 12


class Fp2(NamedTuple):
    c0: torch.Tensor
    c1: torch.Tensor


class G2(NamedTuple):
    x: Fp2
    y: Fp2
    z: Fp2

    @property
    def batch_shape(self):
        return self.x.c0.shape[1:]

    @property
    def device(self):
        return self.x.c0.device


def _map(fn, *pts: G2) -> G2:
    """fn over the six Fp components of one or more points."""
    return G2(*(Fp2(*(fn(*cs) for cs in zip(*fs))) for fs in zip(*pts)))


# --- stacked Fp and Fp2 operations: the pairs of one call are independent ---


def _fp_many(op, pairs) -> tuple:
    """op(FP, a_i, b_i) for every pair, as one call over a stacked axis."""
    xs = torch.broadcast_tensors(*(t for pair in pairs for t in pair))
    return op(FP, torch.stack(xs[0::2], dim=1), torch.stack(xs[1::2], dim=1)).unbind(1)


def _fp2_many(op, pairs) -> list:
    """A componentwise Fp2 operation (add, sub) over every pair, one call."""
    out = _fp_many(op, [(getattr(a, c), getattr(b, c)) for a, b in pairs for c in ("c0", "c1")])
    return [Fp2(out[2 * i], out[2 * i + 1]) for i in range(len(pairs))]


def _adds(*pairs) -> list:
    return _fp2_many(F.add, pairs)


def _subs(*pairs) -> list:
    return _fp2_many(F.sub, pairs)


def _muls(*pairs) -> list:
    """Fp2 products by Karatsuba: t0 = a0 b0, t1 = a1 b1,
    t2 = (a0 + a1)(b0 + b1); c0 = t0 - t1, c1 = t2 - t0 - t1. The 3 n Fp
    products of n pairs are one `mont_mul` call."""
    n = len(pairs)
    sums = _fp_many(F.add, [(x.c0, x.c1) for pair in pairs for x in pair])
    prods = _fp_many(
        F.mont_mul,
        [(a.c0, b.c0) for a, b in pairs] + [(a.c1, b.c1) for a, b in pairs]
        + [(sums[2 * i], sums[2 * i + 1]) for i in range(n)],
    )
    t0, t1, t2 = prods[:n], prods[n : 2 * n], prods[2 * n :]
    s01 = _fp_many(F.add, list(zip(t0, t1)))
    diff = _fp_many(F.sub, list(zip(t0, t1)) + list(zip(t2, s01)))
    return [Fp2(diff[i], diff[n + i]) for i in range(n)]


def _muls_b3(*xs: Fp2) -> list:
    """3 b' a = 12 (1 + u) a = 12 (a0 - a1) + 12 (a0 + a1) u for every a,
    with one `mont_mul` call by the constant 12."""
    n = len(xs)
    d = _fp_many(F.sub, [(a.c0, a.c1) for a in xs]) + _fp_many(F.add, [(a.c0, a.c1) for a in xs])
    twelve = FP.mont_const(B3, xs[0].c0.device)
    out = _fp_many(F.mont_mul, [(v, FP.broadcast(twelve, v.shape[1:])) for v in d])
    return [Fp2(out[i], out[n + i]) for i in range(n)]


# --- Fp2 ---


def fp2_add(a: Fp2, b: Fp2) -> Fp2:
    return _adds((a, b))[0]


def fp2_sub(a: Fp2, b: Fp2) -> Fp2:
    return _subs((a, b))[0]


def fp2_neg(a: Fp2) -> Fp2:
    return Fp2(F.neg(FP, a.c0), F.neg(FP, a.c1))


def fp2_mul(a: Fp2, b: Fp2) -> Fp2:
    """(a0 + a1 u)(b0 + b1 u) with u^2 = -1 (Karatsuba)."""
    return _muls((a, b))[0]


def fp2_mul_b3(a: Fp2) -> Fp2:
    """3 b' a with b' = 4 (1 + u)."""
    return _muls_b3(a)[0]


def fp2_select(cond: torch.Tensor, a: Fp2, b: Fp2) -> Fp2:
    return Fp2(F.select(cond, a.c0, b.c0), F.select(cond, a.c1, b.c1))


def fp2_is_zero(a: Fp2) -> torch.Tensor:
    return F.is_zero(FP, a.c0) & F.is_zero(FP, a.c1)


# --- G2 ---


def identity(batch_shape, device) -> G2:
    zero = torch.zeros((FP.nlimbs,) + tuple(batch_shape), dtype=torch.int32, device=device)
    one = FP.broadcast(FP.one(device), tuple(batch_shape)).contiguous()
    return G2(Fp2(zero, zero.clone()), Fp2(one, zero.clone()), Fp2(zero.clone(), zero.clone()))


def g2_select(cond: torch.Tensor, a: G2, b: G2) -> G2:
    """Lanewise `cond ? a : b`; cond is [*batch]."""
    return _map(lambda ca, cb: F.select(cond, ca, cb), a, b)


def add(p: G2, q: G2) -> G2:
    """Complete projective addition (RCB Algorithm 7, a = 0)."""
    x1, y1, z1 = p
    x2, y2, z2 = q
    s = _adds((x1, y1), (y1, z1), (x1, z1), (x2, y2), (y2, z2), (x2, z2))
    t0, t1, t2, m3, m4, my = _muls((x1, x2), (y1, y2), (z1, z2), (s[0], s[3]), (s[1], s[4]), (s[2], s[5]))
    d3, d4, dy, t0_2 = _subs((m3, t0), (m4, t1), (my, t0)) + _adds((t0, t0))
    t3, t4, ty = _subs((d3, t1), (d4, t2), (dy, t2))  # x1 y2 + x2 y1, y1 z2 + y2 z1, x1 z2 + x2 z1
    (t0_3,) = _adds((t0_2, t0))  # 3 x1 x2
    t2_b, ty_b = _muls_b3(t2, ty)
    (z3,) = _adds((t1, t2_b))
    (t1_n,) = _subs((t1, t2_b))
    a1, a2, b1, b2, c1, c2 = _muls((t3, t1_n), (t4, ty_b), (t1_n, z3), (ty_b, t0_3), (z3, t4), (t0_3, t3))
    (x3,) = _subs((a1, a2))
    y3, z3 = _adds((b1, b2), (c1, c2))
    return G2(x3, y3, z3)


def double(p: G2) -> G2:
    """Complete projective doubling (RCB Algorithm 9, a = 0)."""
    x, y, z = p
    t0, t1, zz, xy = _muls((y, y), (y, z), (z, z), (x, y))
    (t2,) = _muls_b3(zz)  # 3 b' z^2
    (z3,) = _adds((t0, t0))
    (z3,) = _adds((z3, z3))
    (z3,) = _adds((z3, z3))  # 8 y^2
    x3, z3 = _muls((t2, z3), (t1, z3))
    y3, t2_2 = _adds((t0, t2), (t2, t2))
    (t2_3,) = _adds((t2_2, t2))
    (t0,) = _subs((t0, t2_3))  # y^2 - 9 b' z^2
    m1, m2 = _muls((t0, y3), (t0, xy))
    y3, x3 = _adds((m1, x3), (m2, m2))
    return G2(x3, y3, z3)


def scalar_mul(p: G2, scalar_bits: torch.Tensor) -> G2:
    """Double-and-add over MSB-first bit rows [nbits, *batch] (bool): at every
    bit a doubling, an addition of p and a select."""
    acc = identity(p.batch_shape, p.device)
    for bits in scalar_bits:
        acc = double(acc)
        acc = g2_select(bits, add(acc, p), acc)
    return acc


def reduce_sum(p: G2, axis: int) -> G2:
    """Sum along one batch axis by pairwise halving (point k plus point
    k + n/2), padded to a power of two with the identity."""
    p = _map(lambda c: torch.movedim(c, axis if axis < 0 else axis + 1, -1), p)
    n = p.batch_shape[-1]
    pow2 = 1 << max(n - 1, 0).bit_length()
    if pow2 != n:
        idp = identity(tuple(p.batch_shape[:-1]) + (pow2 - n,), p.device)
        p = _map(lambda c, i: torch.cat((c, i), dim=-1), p, idp)
        n = pow2
    while n > 1:
        h = n // 2
        p = add(_map(lambda c: c[..., :h], p), _map(lambda c: c[..., h:], p))
        n = h
    return _map(lambda c: c[..., 0], p)


def g2_lincomb(points: G2, scalars_mont: torch.Tensor) -> G2:
    """sum_i k_i P_i over the last axis: the device form of the reference's
    `g2_lincomb`. points: G2 [*batch, N]; scalars_mont: [8, *batch, N]
    Montgomery Fr. Returns G2 [*batch]."""
    per_point = scalar_mul(points, M.scalar_bits_msb(scalars_mont))
    return reduce_sum(per_point, axis=-1)


# --- host <-> device ---


def points_to_device(points, device) -> G2:
    """Host affine G2 points ((x0, x1), (y0, y1)) or None -> G2 [N]."""
    comps = [[], [], [], [], [], []]  # x0 x1 y0 y1 z0 z1
    for pt in points:
        vals = (0, 0, 1, 0, 0, 0) if pt is None else (*pt[0], *pt[1], 1, 0)
        for lst, v in zip(comps, vals):
            lst.append(v)
    rows = [torch.from_numpy(FP.to_mont_host(c)).to(device) for c in comps]
    return G2(Fp2(rows[0], rows[1]), Fp2(rows[2], rows[3]), Fp2(rows[4], rows[5]))


def _fp2_mul_host(a, b):
    return (a[0] * b[0] - a[1] * b[1]) % P, (a[0] * b[1] + a[1] * b[0]) % P


def points_from_device(p: G2) -> list:
    """G2 (any batch shape, flattened) -> host affine points, None for the
    identity (one fetch; the inversions of Z on the host)."""
    rows = [FP.from_mont_host(c.reshape(FP.nlimbs, -1).cpu().numpy()) for f in p for c in f]
    out = []
    for x0, x1, y0, y1, z0, z1 in zip(*rows):
        if z0 == 0 and z1 == 0:
            out.append(None)
            continue
        ninv = pow((z0 * z0 + z1 * z1) % P, P - 2, P)
        zinv = (z0 * ninv % P, (P - z1) * ninv % P)
        out.append((_fp2_mul_host((x0, x1), zinv), _fp2_mul_host((y0, y1), zinv)))
    return out

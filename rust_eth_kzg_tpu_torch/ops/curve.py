"""Batched G1 arithmetic on torch tensors: complete projective formulas over Fp.

A point set is a `G1` of three Montgomery Fp limb tensors `[12, *batch]`,
each coordinate fully reduced; the identity is (0 : R : 0), i.e. (0 : 1 : 0).
Affine point sets (`G1Affine`) carry an identity mask, with (0, 0) in the
identity lanes.

`add`, `double`, `add_mixed` and `add_affine` launch the CUDA kernels of
`ops/kernels.py` for CUDA tensors and run the plain versions below
(`add_plain`, `double_plain`, `add_mixed_plain`, `add_affine_plain`: the same
formulas as plain field ops) for CPU tensors. The formulas are those of
rust_eth_kzg_tpu/ops/curve.py (Renes-Costello-Batina 2015 with a = 0, and the
incomplete chord addition), so the canonical projective coordinates agree
with the JAX package's.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..constants import GLV_BASIS, GLV_BETA, GLV_LAMBDA, GLV_NBITS, R_SCALAR
from . import field as F
from . import kernels as K

FP = F.FP
B3 = 12  # 3 b for y^2 = x^3 + 4


class G1(NamedTuple):
    """Projective (X : Y : Z), each [12, *batch] Montgomery limbs."""

    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    @property
    def batch_shape(self):
        return self.x.shape[1:]

    @property
    def device(self):
        return self.x.device


class G1Affine(NamedTuple):
    """Affine (x, y) [12, *batch] plus an identity mask [*batch]."""

    x: torch.Tensor
    y: torch.Tensor
    inf: torch.Tensor


def identity(batch_shape, device) -> G1:
    zero = torch.zeros((FP.nlimbs,) + tuple(batch_shape), dtype=torch.int32, device=device)
    one = FP.broadcast(FP.one(device), tuple(batch_shape)).contiguous()
    return G1(x=zero, y=one, z=zero.clone())


def _map(fn, *pts):
    return G1(*(fn(*cs) for cs in zip(*pts)))


# --- plain versions of the kernels ---
# The same formulas as the kernels; independent field operations of one step
# run as one batched call (stacked on a new axis) to cut per-call overhead.


def _run(op, pairs):
    xs = torch.broadcast_tensors(*(t for pair in pairs for t in pair))
    a = torch.stack(xs[0::2], dim=1)
    b = torch.stack(xs[1::2], dim=1)
    return op(FP, a, b).unbind(1)


def _muls(*pairs):
    return _run(F.mont_mul_plain, pairs)


def _adds(*pairs):
    return _run(F.add, pairs)


def _subs(*pairs):
    return _run(F.sub, pairs)


def add_plain(p: G1, q: G1) -> G1:
    """Complete projective addition (RCB Algorithm 7, a = 0)."""
    x1, y1, z1 = p
    x2, y2, z2 = q
    b3 = FP.mont_const(B3, x1.device).reshape(-1, *([1] * (x1.dim() - 1)))
    t0, t1, t2 = _muls((x1, x2), (y1, y2), (z1, z2))
    s = _adds((x1, y1), (y1, z1), (x1, z1), (x2, y2), (y2, z2), (x2, z2))
    m3, m4, my = _muls((s[0], s[3]), (s[1], s[4]), (s[2], s[5]))
    d3, d4, dy = _subs((m3, t0), (m4, t1), (my, t0))
    t3, t4, ty = _subs((d3, t1), (d4, t2), (dy, t2))
    (t0_2,) = _adds((t0, t0))
    (t0_3,) = _adds((t0_2, t0))  # 3 x1 x2
    t2_b, ty_b = _muls((t2, b3), (ty, b3))
    (z3,) = _adds((t1, t2_b))
    (t1_n,) = _subs((t1, t2_b))
    a1, a2, b1, b2, c1, c2 = _muls(
        (t3, t1_n), (t4, ty_b), (t1_n, z3), (ty_b, t0_3), (z3, t4), (t0_3, t3)
    )
    (x3,) = _subs((a1, a2))
    y3, z3 = _adds((b1, b2), (c1, c2))
    return G1(x3, y3, z3)


def double_plain(p: G1) -> G1:
    """Complete projective doubling (RCB Algorithm 9, a = 0)."""
    x, y, z = p
    b3 = FP.mont_const(B3, x.device).reshape(-1, *([1] * (x.dim() - 1)))
    t0, t1, zz, xy = _muls((y, y), (y, z), (z, z), (x, y))
    (t2,) = _muls((zz, b3))  # 3b z^2
    (z3,) = _adds((t0, t0))
    (z3,) = _adds((z3, z3))
    (z3,) = _adds((z3, z3))  # 8 y^2
    x3, z3 = _muls((t2, z3), (t1, z3))
    y3, t2_2 = _adds((t0, t2), (t2, t2))
    (t2_3,) = _adds((t2_2, t2))
    (t0,) = _subs((t0, t2_3))  # y^2 - 9b z^2
    m1, m2 = _muls((t0, y3), (t0, xy))
    y3, x3 = _adds((m1, x3), (m2, m2))
    return G1(x3, y3, z3)


def add_mixed_plain(p: G1, q: G1Affine) -> G1:
    """Complete mixed addition (RCB Algorithm 8, a = 0): q has Z = 1; lanes
    where `q.inf` is set return p unchanged."""
    x1, y1, z1 = p
    x2, y2 = q.x, q.y
    b3 = FP.mont_const(B3, x1.device).reshape(-1, *([1] * (x1.dim() - 1)))
    s1, s2 = _adds((x1, y1), (x2, y2))
    t0, t1, m3, yz, xz, t2_b = _muls((x1, x2), (y1, y2), (s1, s2), (y2, z1), (x2, z1), (z1, b3))
    (d3,) = _subs((m3, t0))
    (t3,) = _subs((d3, t1))  # x1 y2 + x2 y1
    t4, ty = _adds((yz, y1), (xz, x1))  # y1 + y2 z1, x1 + x2 z1
    (t0_2,) = _adds((t0, t0))
    (t0_3,) = _adds((t0_2, t0))
    (z3,) = _adds((t1, t2_b))
    (t1_n,) = _subs((t1, t2_b))
    (ty_b,) = _muls((ty, b3))
    a1, a2, b1, b2, c1, c2 = _muls(
        (t3, t1_n), (t4, ty_b), (t1_n, z3), (ty_b, t0_3), (z3, t4), (t0_3, t3)
    )
    (x3,) = _subs((a1, a2))
    y3, z3 = _adds((b1, b2), (c1, c2))
    return select(q.inf, p, G1(x3, y3, z3))


def add_affine_plain(a: G1Affine, b: G1Affine) -> G1:
    """Affine + affine -> projective chord addition; an identity operand passes
    the other through; equal non-identity inputs give (0 : 0 : 0)."""
    x1, y1 = a.x, a.y
    x2, y2 = b.x, b.y
    u, v = _subs((y2, y1), (x2, x1))
    usq, vsq = _muls((u, u), (v, v))
    (s,) = _adds((x1, x2))
    vcu, d, t = _muls((v, vsq), (vsq, s), (x1, vsq))
    (w,) = _subs((usq, d))  # x3 v^2
    (t,) = _subs((t, w))
    x3, m1, m2 = _muls((v, w), (u, t), (y1, vcu))
    (y3,) = _subs((m1, m2))
    device = x1.device
    one = FP.broadcast(FP.one(device), x3.shape[1:])
    zero = torch.zeros_like(x3)
    pa = G1(F.select(a.inf, zero, x1), F.select(a.inf, one, y1), F.select(a.inf, zero, one))
    pb = G1(F.select(b.inf, zero, x2), F.select(b.inf, one, y2), F.select(b.inf, zero, one))
    out = select(b.inf, pa, G1(x3, y3, vcu))
    return select(a.inf, pb, out)


# --- public group operations ---


def add(p: G1, q: G1) -> G1:
    if p.x.device.type == "cpu":
        return add_plain(p, q)
    return G1(*K.g1_add(p, q))


def double(p: G1) -> G1:
    if p.x.device.type == "cpu":
        return double_plain(p)
    return G1(*K.g1_double(p))


def add_mixed(p: G1, q: G1Affine) -> G1:
    if p.x.device.type == "cpu":
        return add_mixed_plain(p, q)
    return G1(*K.g1_add_mixed(p, q.x, q.y, q.inf))


def add_affine(a: G1Affine, b: G1Affine) -> G1:
    if a.x.device.type == "cpu":
        return add_affine_plain(a, b)
    return G1(*K.g1_add_affine(a.x, a.y, a.inf, b.x, b.y, b.inf))


def neg(p: G1) -> G1:
    return G1(p.x, F.neg(FP, p.y), p.z)


def select(cond: torch.Tensor, a: G1, b: G1) -> G1:
    """Lanewise `cond ? a : b`; cond is [*batch]."""
    return G1(*(torch.where(cond[None], ca, cb) for ca, cb in zip(a, b)))


def is_identity(p: G1) -> torch.Tensor:
    return F.is_zero(FP, p.z)


def equal(p: G1, q: G1, plain: bool = False) -> torch.Tensor:
    """Projective equality x1 z2 == x2 z1 and y1 z2 == y2 z1, identity-aware.
    With `plain` the products are `mont_mul_plain` on any device."""
    mul = F.mont_mul_plain if plain else F.mont_mul
    ip, iq = is_identity(p), is_identity(q)
    ex = F.equal(FP, mul(FP, p.x, q.z), mul(FP, q.x, p.z))
    ey = F.equal(FP, mul(FP, p.y, q.z), mul(FP, q.y, p.z))
    return (ip & iq) | (~(ip ^ iq) & ex & ey)


def reduce_sum(p: G1, axis: int = -1, plain: bool = False) -> G1:
    """Sum along one batch axis by pairwise halving (n - 1 additions): point
    k plus point k + n/2, padded to a power of two with the identity. With
    `plain` the plain formulas run on any device."""
    add_ = add_plain if plain else add
    p = _map(lambda c: torch.movedim(c, axis if axis < 0 else axis + 1, -1), p)
    n = p.x.shape[-1]
    pow2 = 1 << max(n - 1, 0).bit_length()
    if pow2 != n:
        idp = identity(p.batch_shape[:-1] + (pow2 - n,), p.device)
        p = _map(lambda c, i: torch.cat((c, i), dim=-1), p, idp)
        n = pow2
    while n > 1:
        h = n // 2
        p = add_(_map(lambda c: c[..., :h], p), _map(lambda c: c[..., h:], p))
        n = h
    return _map(lambda c: c[..., 0], p)


# --- GLV endomorphism: phi(x, y) = (beta x, y) acts as multiplication by
# lambda; scalars split into two ~128-bit halves ---


def _round_div(a: int, b: int) -> int:
    """round(a / b) for b > 0, correct for negative a."""
    return (2 * a + b) // (2 * b)


def glv_decompose(k: int):
    """k -> (|k1|, k1 < 0, |k2|, k2 < 0) with k = k1 + k2 lambda (mod r)."""
    x1, y1, x2, y2 = GLV_BASIS
    det = x1 * y2 - x2 * y1
    if det < 0:
        x1, y1, x2, y2, det = -x1, -y1, -x2, -y2, -det
    k %= R_SCALAR
    c1 = _round_div(k * y2, det)
    c2 = _round_div(-k * y1, det)
    k1 = k - c1 * x1 - c2 * x2
    k2 = -(c1 * y1 + c2 * y2)
    if (k1 + k2 * GLV_LAMBDA) % R_SCALAR != k or max(abs(k1), abs(k2)) >= 1 << (GLV_NBITS - 1):
        raise ArithmeticError(f"GLV decomposition failed for {k}")
    return abs(k1), k1 < 0, abs(k2), k2 < 0


def glv_bits_host(scalars):
    """Host ints -> (bits1 [GLV_NBITS, N], neg1 [N], bits2, neg2) numpy bools, MSB first."""
    n = len(scalars)
    nbytes = (GLV_NBITS + 7) // 8
    raw1, raw2 = bytearray(n * nbytes), bytearray(n * nbytes)
    neg1 = np.zeros(n, dtype=bool)
    neg2 = np.zeros(n, dtype=bool)
    for i, k in enumerate(scalars):
        a1, n1, a2, n2 = glv_decompose(int(k))
        neg1[i], neg2[i] = n1, n2
        raw1[i * nbytes : (i + 1) * nbytes] = a1.to_bytes(nbytes, "big")
        raw2[i * nbytes : (i + 1) * nbytes] = a2.to_bytes(nbytes, "big")
    pad = 8 * nbytes - GLV_NBITS

    def bits(raw):
        arr = np.frombuffer(bytes(raw), dtype=np.uint8).reshape(n, nbytes)
        return np.unpackbits(arr, axis=1)[:, pad:].T.astype(bool)

    return bits(raw1), neg1, bits(raw2), neg2


def glv_digits_host(scalars):
    """Host ints -> (digits uint8 [GLV_NBITS / 2, N], neg1 bool [N], neg2 bool [N]):
    the joint width-2 window digits 4 d1 + d2 of the two half scalars, MSB first."""
    b1, n1, b2, n2 = glv_bits_host(scalars)
    d1 = 2 * b1[0::2].astype(np.uint8) + b1[1::2]
    d2 = 2 * b2[0::2].astype(np.uint8) + b2[1::2]
    return (4 * d1 + d2).astype(np.uint8), n1, n2


def glv_endomorphism(p: G1) -> G1:
    return G1(F.mont_mul_const(FP, p.x, GLV_BETA), p.y, p.z)


def scalar_mul_glv(p: G1, digits, neg1, neg2, plain: bool = False) -> G1:
    """k p by the GLV split with width-2 windows: a 16-entry table
    {a P1 + b P2 : a, b in 0..3} (entry 4 a + b) and 65 steps of
    (2 doublings + 1 addition), one per joint digit.

    digits: integer [GLV_NBITS / 2, *batch] in 0..15, MSB first (`glv_digits_host`);
    neg*: bool or 0/1 [*batch], the signs of the two half scalars. With
    `plain` the plain formulas run on any device (the reference that the
    `g1_fft` kernel is held against on the card); otherwise each group
    operation goes to its kernel for CUDA tensors.
    """
    add_, double_ = (add_plain, double_plain) if plain else (add, double)
    mul = F.mont_mul_plain if plain else F.mont_mul
    batch = p.batch_shape
    neg1, neg2 = neg1.to(torch.bool), neg2.to(torch.bool)
    p1 = select(neg1, neg(p), p)
    phi = G1(mul(FP, p.x, FP.broadcast(FP.mont_const(GLV_BETA, p.device), batch)), p.y, p.z)
    p2 = select(neg2, neg(phi), phi)
    ident = identity(batch, p.device)
    p1_2 = double_(p1)
    p1_3 = add_(p1_2, p1)
    p2_2 = double_(p2)
    p2_3 = add_(p2_2, p2)
    row0 = [ident, p2, p2_2, p2_3]
    entries = row0 + [add_(e, p1) for e in row0] + [add_(e, p1_2) for e in row0]
    entries += [add_(e, p1_3) for e in row0]
    table = G1(*(torch.stack([e[i] for e in entries]) for i in range(3)))  # [16, L, *batch]

    idx_shape = (1, FP.nlimbs) + tuple(batch)
    acc = ident
    for d in digits.to(torch.int64):
        acc = double_(double_(acc))
        idx = d.reshape((1, 1) + tuple(batch)).expand(idx_shape)
        acc = add_(acc, G1(*(torch.gather(c, 0, idx)[0] for c in table)))
    return acc


def scalar_mul_static(q: G1Affine, k: int, plain: bool = False) -> G1:
    """k q for a host integer k (the subgroup check's z^2 - 1): MSB-first
    double-and-add over k's bits, each addend q through `add_mixed`. k is
    known on the host, so a zero bit costs a doubling and no addition; the
    point equals the JAX ladder's, which adds and selects at every bit.
    With `plain` the plain formulas run on any device."""
    add_mixed_, double_ = (add_mixed_plain, double_plain) if plain else (add_mixed, double)
    acc = identity(q.x.shape[1:], q.x.device)
    for bit in bin(max(k, 0))[2:]:
        acc = double_(acc)
        if bit == "1":
            acc = add_mixed_(acc, q)
    return acc


def batch_normalize(p: G1) -> G1Affine:
    """Projective -> affine over the whole batch with one batched inversion;
    identity lanes are flagged and set to (0, 0)."""
    batch = p.batch_shape
    flat = _map(lambda c: c.reshape(FP.nlimbs, -1), p)
    inf = is_identity(flat)
    one = FP.broadcast(FP.one(p.device), flat.batch_shape)
    zinv = F.batch_inverse(FP, F.select(inf, one, flat.z).contiguous())
    zero = torch.zeros_like(flat.x)
    x = F.select(inf, zero, F.mont_mul(FP, flat.x, zinv))
    y = F.select(inf, zero, F.mont_mul(FP, flat.y, zinv))
    return G1Affine(
        x=x.reshape((FP.nlimbs,) + tuple(batch)),
        y=y.reshape((FP.nlimbs,) + tuple(batch)),
        inf=inf.reshape(batch),
    )


# --- host <-> device ---


def points_to_device(points, device) -> G1:
    """Host affine points ((x, y) ints or None) -> projective G1 [N]."""
    xs, ys, zs = [], [], []
    for pt in points:
        if pt is None:
            xs.append(0)
            ys.append(1)
            zs.append(0)
        else:
            xs.append(pt[0])
            ys.append(pt[1])
            zs.append(1)
    packed = np.concatenate([FP.to_mont_host(xs), FP.to_mont_host(ys), FP.to_mont_host(zs)])
    dev = torch.from_numpy(packed).to(device)
    nl = FP.nlimbs
    return G1(dev[:nl], dev[nl : 2 * nl], dev[2 * nl :])


def affine_to_device(points, device) -> G1Affine:
    """Host affine points ((x, y) ints or None) -> G1Affine [N], (0, 0) on
    identity lanes."""
    xs = [0 if pt is None else pt[0] for pt in points]
    ys = [0 if pt is None else pt[1] for pt in points]
    packed = torch.from_numpy(np.concatenate([FP.to_mont_host(xs), FP.to_mont_host(ys)])).to(device)
    inf = torch.tensor([pt is None for pt in points], dtype=torch.bool, device=device)
    return G1Affine(packed[: FP.nlimbs], packed[FP.nlimbs :], inf)


def affine_from_device(aff: G1Affine) -> list:
    """G1Affine (any batch shape, flattened) -> host affine points / None."""
    xs = FP.from_mont_host(aff.x.reshape(FP.nlimbs, -1).cpu().numpy())
    ys = FP.from_mont_host(aff.y.reshape(FP.nlimbs, -1).cpu().numpy())
    inf = aff.inf.reshape(-1).cpu().numpy()
    return [None if i else (x, y) for x, y, i in zip(xs, ys, inf)]


def points_from_device(p: G1) -> list:
    return affine_from_device(batch_normalize(p))

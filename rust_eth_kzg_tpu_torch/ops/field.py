"""Batched prime-field arithmetic on torch tensors: Montgomery form over 32-bit limbs.

An element is `L` little-endian 32-bit limbs, limb-major `[L, *batch]`, held
as int32 bit patterns. Every value is kept fully reduced, below the modulus,
after every operation: with 32-bit limbs the Montgomery radix R = 2^(32 L)
leaves too little headroom (3 bits for Fp, 1 for Fr) for lazily reduced
values, so no operation returns a multiple of p.

`mont_mul` and `batch_inverse` launch the CUDA kernels of `ops/kernels.py`
for tensors on the card; for tensors on the CPU they run the plain versions
below (`mont_mul_plain`, `batch_inverse_plain`), which compute the same
canonical values with int64 tensor ops. `butterfly_plain` is one NTT stage:
the plain version of the standalone `field_butterfly` kernel and the stage
of `ntt.Domain._dit_plain`. A 32 x 32-bit
product does not fit a signed int64, so the plain versions work on 16-bit
halves of each limb, keeping the same R.

The remaining operations (add, sub, neg, select, canonical) are plain torch on
either device.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field

import numpy as np
import torch

from ..constants import FP_LIMBS, FR_LIMBS, LIMB_BITS, P, R_SCALAR
from . import kernels as K
from . import limbs as limb_utils

_M16 = 0xFFFF
_M32 = 0xFFFFFFFF


@dataclass(frozen=True, eq=False)
class FieldSpec:
    """Per-field constants; device copies are made on first use."""

    name: str
    modulus: int
    nlimbs: int
    r: int = field(init=False)  # Montgomery radix 2^(32 L)
    r_mod_p: int = field(init=False)
    r2_mod_p: int = field(init=False)
    n0: int = field(init=False)  # -p^-1 mod 2^32
    _consts: dict = field(init=False, repr=False)

    def __post_init__(self):
        r = 1 << (LIMB_BITS * self.nlimbs)
        object.__setattr__(self, "r", r)
        object.__setattr__(self, "r_mod_p", r % self.modulus)
        object.__setattr__(self, "r2_mod_p", r * r % self.modulus)
        object.__setattr__(self, "n0", (-pow(self.modulus, -1, 1 << 32)) % (1 << 32))
        object.__setattr__(self, "_consts", {})

    # --- host conversions ---

    def to_mont_host(self, values) -> np.ndarray:
        """Python ints -> Montgomery limbs [L, N] int32."""
        m = self.modulus
        return limb_utils.ints_to_limbs(
            [int(v) % m * self.r_mod_p % m for v in values], self.nlimbs
        )

    def from_mont_host(self, limbs) -> list:
        """Montgomery limbs [L, N] -> canonical ints."""
        r_inv = pow(self.r_mod_p, -1, self.modulus)
        return [v * r_inv % self.modulus for v in limb_utils.limbs_to_ints(limbs)]

    # --- device constants ---

    def const(self, value: int, device) -> torch.Tensor:
        """The limbs of an integer constant as a [L] int32 tensor on `device`."""
        key = ("int", value, str(torch.device(device)))
        got = self._consts.get(key)
        if got is None:
            got = torch.from_numpy(limb_utils.int_to_limbs(value, self.nlimbs)).to(device)
            self._consts[key] = got
        return got

    def mont_const(self, value: int, device) -> torch.Tensor:
        """value * R mod p as [L] limbs (a constant in Montgomery form)."""
        return self.const(value % self.modulus * self.r_mod_p % self.modulus, device)

    def one(self, device) -> torch.Tensor:
        return self.const(self.r_mod_p, device)

    def _plain_consts(self, device):
        """16-bit-limb constants of the plain versions, cached per device."""
        key = ("plain", str(torch.device(device)))
        got = self._consts.get(key)
        if got is None:
            k = 2 * self.nlimbs
            nprime = (-pow(self.modulus, -1, self.r)) % self.r
            got = {
                "p16": _ints16(self.modulus, k, device),
                "np16": _ints16(nprime, k, device),
                # 2^(16 k) - p: adding it subtracts p modulo 2^(16 k)
                "negp16": _ints16((1 << (16 * k)) - self.modulus, k, device),
            }
            self._consts[key] = got
        return got

    def broadcast(self, const: torch.Tensor, batch_shape) -> torch.Tensor:
        return const.reshape((self.nlimbs,) + (1,) * len(batch_shape)).expand(
            (self.nlimbs,) + tuple(batch_shape)
        )


FR = FieldSpec(name="fr", modulus=R_SCALAR, nlimbs=FR_LIMBS)
FP = FieldSpec(name="fp", modulus=P, nlimbs=FP_LIMBS)


# --- 16-bit helpers of the plain versions ---


def _ints16(value: int, k: int, device) -> torch.Tensor:
    return torch.tensor(
        [(value >> (16 * i)) & _M16 for i in range(k)], dtype=torch.int64, device=device
    )


def _split16(a: torch.Tensor) -> torch.Tensor:
    """int32 limbs [L, M] -> int64 16-bit limbs [2L, M]."""
    u = a.to(torch.int64) & _M32
    return torch.stack((u & _M16, u >> 16), dim=1).reshape(2 * a.shape[0], -1)


def _join16(x: torch.Tensor) -> torch.Tensor:
    """Normalized int64 16-bit limbs [2L, M] -> int32 limbs [L, M]."""
    x = x.reshape(x.shape[0] // 2, 2, -1)
    v = x[:, 0] | (x[:, 1] << 16)
    return (v - ((v >> 31) << 32)).to(torch.int32)


@functools.lru_cache(maxsize=None)
def _positions(k: int, device: str) -> torch.Tensor:
    return torch.arange(k, device=device).reshape(k, 1)


def _carry(x: torch.Tensor, rounds: int) -> torch.Tensor:
    """Propagate carries through non-negative int64 16-bit limbs [K, M].

    `rounds` parallel rounds must bring every limb below 2^17 (the callers
    know their input bounds: two rounds from column sums below 2^37, one
    from sums below 2^18, none from sums below 2^17); one carry-lookahead
    pass then settles the remaining 0/1 carries, whose chains may run the
    whole length. The carry out of the top limb is dropped: the result is
    the value mod 2^(16 K).
    """
    for _ in range(rounds):
        hi = x >> 16
        x = x & _M16
        x[1:] += hi[:-1]
    gen = x >> 16
    x = x & _M16
    # carry into limb i + 1: gen at the last limb j <= i that does not just
    # propagate (gen set, or limb below 0xFFFF)
    stop = (gen != 0) | (x != _M16)
    last = torch.cummax(torch.where(stop, _positions(x.shape[0], str(x.device)), -1), dim=0).values
    carry = torch.where(last >= 0, torch.gather(gen, 0, last.clamp(min=0)), 0)
    x[1:] += carry[:-1]
    return x & _M16


def _cond_sub16(x: torch.Tensor, negp16: torch.Tensor) -> torch.Tensor:
    """x (normalized, value < 2p) -> x mod p, as normalized 16-bit limbs.

    x - p is computed as x + (2^(16 K) - p); a carry out of the top limb
    means x >= p.
    """
    d = _carry(torch.cat((x + negp16[:, None], torch.zeros_like(x[:1])), dim=0), 0)
    return torch.where(d[-1:] != 0, d[:-1], x)


def _flat(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    return a.reshape(spec.nlimbs, -1)


# --- plain versions of the kernels ---


def mont_mul_plain(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b * R^-1 mod p, fully reduced; a < 2p and b < p.

    Schoolbook products of 16-bit halves summed per column (each column
    < 2^37), then one Montgomery reduction by the whole radix:
    m = (t mod R) * (-p^-1) mod R, and (t + m p) / R < 2p.
    """
    a, b = torch.broadcast_tensors(a, b)
    shape = a.shape
    consts = spec._plain_consts(a.device)
    p16, np16, negp16 = (consts[k] for k in ("p16", "np16", "negp16"))
    k = 2 * spec.nlimbs
    a16, b16 = _split16(_flat(spec, a)), _split16(_flat(spec, b))
    m_lanes = a16.shape[1]

    def product(x, y):  # column sums of the schoolbook product [2k, M]
        # row i of the outer product shifted right by i (skewed through a
        # reshape), then summed over the rows
        outer = torch.nn.functional.pad(x[:, None, :] * y[None, :, :], (0, 0, 0, k + 1))
        return outer.reshape(k * (2 * k + 1), -1)[: 2 * k * k].reshape(k, 2 * k, -1).sum(0)

    t = _carry(product(a16, b16), 2)
    m = _carry(product(t[:k], np16[:, None].expand(k, m_lanes))[:k], 2)  # mod R
    mp = _carry(product(m, p16[:, None].expand(k, m_lanes)), 2)
    # t + m p = 0 mod R, so its low half is 0 (t_lo = 0) or R (otherwise)
    low_carry = torch.any(t[:k] != 0, dim=0).to(torch.int64)
    u = t[k:] + mp[k:]
    u[0] += low_carry
    out = _cond_sub16(_carry(u, 0), negp16)
    return _join16(out).reshape(shape)


def batch_inverse_plain(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """Elementwise inverse of [L, N] Montgomery limbs: the definition of the
    `batch_inverse` kernel's contract.

    Lane i falls in block i mod C (C = ceil(N / 32)) at position i // C;
    each block takes prefix products, one Fermat inversion of its total and
    a backward pass. A zero lane makes its whole block zero. On nonzero
    lanes the inverse is unique, so the kernel's GCD gives the same limbs.
    """
    n = a.shape[1]
    c = max(1, -(-n // 32))
    pad = 32 * c - n
    if pad:
        a = torch.cat((a, spec.broadcast(spec.one(a.device), (pad,))), dim=1)
    x = a.reshape(spec.nlimbs, 32, c)
    acc = spec.broadcast(spec.one(a.device), (c,))
    prefix = []
    for i in range(32):
        prefix.append(acc)
        acc = mont_mul_plain(spec, acc, x[:, i])
    inv = pow_fixed(spec, acc, spec.modulus - 2, plain=True)
    out = [None] * 32
    for i in range(31, -1, -1):
        out[i] = mont_mul_plain(spec, inv, prefix[i])
        inv = mont_mul_plain(spec, inv, x[:, i])
    return torch.stack(out, dim=1).reshape(spec.nlimbs, 32 * c)[:, :n]


def butterfly_plain(
    spec: FieldSpec, x: torch.Tensor, tw: torch.Tensor, stage: int
) -> torch.Tensor:
    """One radix-2 DIT stage over [L, rows, n]: for each pair (a, b) at
    distance h = 2^stage, (a + w b, a - w b) with w = tw[pos * n / (2h)]."""
    nl, rows, n = x.shape
    h = 1 << stage
    v = x.reshape(nl, rows, n // (2 * h), 2, h)
    a, b = v[:, :, :, 0], v[:, :, :, 1]
    w = tw[:, :: n // (2 * h)][:, :h].reshape(nl, 1, 1, h)
    t = mont_mul_plain(spec, b, w)
    return torch.stack((add(spec, a, t), sub(spec, a, t)), dim=3).reshape(nl, rows, n)


# --- public field operations (all values fully reduced) ---


def mont_mul(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery product a * b * R^-1 mod p; a < 2p, b < p; result < p."""
    if a.device.type == "cpu":
        return mont_mul_plain(spec, a, b)
    return K.mont_mul(spec, a, b)


def mont_mul_const(spec: FieldSpec, a: torch.Tensor, value: int) -> torch.Tensor:
    """a * value (value a plain integer; its Montgomery form multiplies a)."""
    c = spec.broadcast(spec.mont_const(value, a.device), a.shape[1:])
    return mont_mul(spec, a, c)


def to_mont(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """Canonical standard-form limbs -> Montgomery form."""
    return mont_mul(spec, a, spec.broadcast(spec.const(spec.r2_mod_p, a.device), a.shape[1:]))


def from_mont(spec: FieldSpec, a: torch.Tensor, plain: bool = False) -> torch.Tensor:
    """Montgomery form -> canonical standard form in [0, p). With `plain` the
    product is `mont_mul_plain` on any device."""
    mul = mont_mul_plain if plain else mont_mul
    return mul(spec, a, spec.broadcast(spec.const(1, a.device), a.shape[1:]))


def _elementwise16(spec: FieldSpec, fn, *xs: torch.Tensor) -> torch.Tensor:
    xs = torch.broadcast_tensors(*xs)
    shape = xs[0].shape
    out = fn(spec._plain_consts(xs[0].device), *(_split16(_flat(spec, x)) for x in xs))
    return _join16(out).reshape(shape)


def _add16(c, x, y):
    return _cond_sub16(_carry(x + y, 0), c["negp16"])


def _sub16(c, x, y):
    # x - y + p as x + (2^(16 K) - 1 - y) + 1 + p, dropping the top carry
    d = x + (_M16 - y) + c["p16"][:, None]
    d[0] += 1
    return _cond_sub16(_carry(d, 1), c["negp16"])


def add(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _elementwise16(spec, _add16, a, b)


def sub(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _elementwise16(spec, _sub16, a, b)


def neg(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    return sub(spec, torch.zeros_like(a), a)


def double(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    return add(spec, a, a)


def canonical(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """A value < 2p reduced into [0, p) (the identity on reduced values)."""
    return _elementwise16(spec, lambda c, x: _cond_sub16(x, c["negp16"]), a)


def select(cond: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Lanewise `cond ? a : b`; cond is [*batch], a and b are [L, *batch]."""
    return torch.where(cond[None], a, b)


def is_zero(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    return torch.all(a == 0, dim=0)


def equal(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.all(a == b, dim=0)


def pow_fixed(spec: FieldSpec, a: torch.Tensor, exponent: int, plain: bool = False) -> torch.Tensor:
    """a^exponent in Montgomery form (square-and-multiply over host bits).
    With `plain` the products are `mont_mul_plain` on any device."""
    mul = mont_mul_plain if plain else mont_mul
    acc = spec.broadcast(spec.one(a.device), a.shape[1:]).contiguous()
    for bit in bin(max(exponent, 0))[2:]:
        acc = mul(spec, acc, acc)
        if bit == "1":
            acc = mul(spec, acc, a)
    return acc


def batch_inverse(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """Elementwise Montgomery inverse: the `batch_inverse` kernel (a binary
    GCD) for CUDA tensors, `batch_inverse_plain` for CPU tensors.

    A zero lane makes its block zero: callers mask zero lanes first.
    """
    shape = a.shape
    flat = a.reshape(spec.nlimbs, -1)
    if a.device.type == "cpu":
        out = batch_inverse_plain(spec, flat)
    else:
        out = K.batch_inverse(spec, flat)
    return out.reshape(shape)


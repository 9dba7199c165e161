"""Batched G1 decompression with on-curve and subgroup flags, on torch tensors.

The byte-level format checks stay on the host (vectorized numpy, the
reference's error taxonomy: `parse_compressed_g1_batch`); the field work
runs batched on the device (`decompress_g1`): on CUDA tensors one launch of
the fused `g1_decompress` kernel (`csrc/g1_decompress.cu`), on CPU tensors
its plain version `decompress_g1_plain`, which computes
- the Fp square root as one fixed exponentiation rhs^((p+1)/4) (p = 3 mod 4);
- the on-curve check: does the candidate square back to x^3 + 4;
- the sign from the compression sort bit: y is the larger root iff its
  standard-form value is >= (p - 1)/2 + 1 (compared in standard form; the
  Montgomery residues order differently);
- the subgroup check through the GLV endomorphism, P in G1 iff
  phi(P) == [z^2 - 1] P with phi(x, y) = (beta x, y), whose ladder adds the
  affine P with `curve.add_mixed`.

`decompress_g1` returns flags instead of raising; `raise_for_flags` turns the
fetched flags into the reference's errors, every not-on-curve point before
any subgroup failure. The flags of a lane that is not on the curve say
nothing about its subgroup.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import B_COEFF, BLS_X, GLV_BETA, P
from ..errors import SerializationError
from . import curve as C
from . import field as F
from . import kernels as K

FP = F.FP

_P_BYTES = np.frombuffer(P.to_bytes(48, "big"), dtype=np.uint8)
_SQRT_EXP = (P + 1) // 4
_HALF_P_PLUS_1 = (P - 1) // 2 + 1
SUBGROUP_SCALAR = BLS_X**2 - 1


# the byte-level error classes, in the order a point is checked for them
BYTE_ERRORS = (
    "uncompressed G1 encodings are not accepted",
    "invalid infinity encoding",
    "coordinate not canonical",
)


def parse_compressed_g1_codes(points: list[bytes]):
    """Byte-level validation and x extraction (host, vectorized), lane by
    lane: returns (x_std [12, N] int32 standard-form limbs, sort_bits [N]
    bool, inf [N] bool, code [N] int8), code 0 for a well-formed lane, else
    1 + the index in BYTE_ERRORS of the first check it fails (x is zero on
    such a lane). Every point must be 48 bytes long."""
    n = len(points)
    raw = np.frombuffer(b"".join(bytes(p) for p in points), np.uint8).reshape(n, 48).copy()
    flags = raw[:, 0]
    comp = (flags & 0x80) != 0
    inf = (flags & 0x40) != 0
    sort = (flags & 0x20) != 0
    raw[:, 0] &= 0x1F
    bad_inf = inf & (sort | raw.any(axis=1))
    # canonicity: x < p, a lexicographic big-endian compare (non-infinity lanes)
    diff = raw.astype(np.int16) - _P_BYTES.astype(np.int16)
    first = np.argmax(diff != 0, axis=1)
    ge_p = diff[np.arange(n), first] >= 0  # all-equal rows compare >= too
    bad_canon = ge_p & ~inf
    code = np.where(~comp, 1, np.where(bad_inf, 2, np.where(bad_canon, 3, 0))).astype(np.int8)
    raw[code != 0] = 0
    words = np.ascontiguousarray(raw[:, ::-1]).view("<u4")  # [N, 12] little-endian words
    x_std = np.ascontiguousarray(words.T).astype(np.uint32).view(np.int32)
    return x_std, sort, inf, code


def parse_compressed_g1_batch(points: list[bytes]):
    """Byte-level validation and x extraction (host, vectorized).

    Returns (x_std [12, N] int32 standard-form limbs, sort_bits [N] bool,
    inf [N] bool). Raises SerializationError naming the first offending index
    for the byte-level error classes, one class after another: length,
    compression bit, infinity encoding, non-canonical x. On-curve and
    subgroup failures are found on the device (`decompress_g1`).
    """
    for i, p in enumerate(points):
        if len(p) != 48:
            raise SerializationError(f"G1 point {i} has invalid length {len(p)}, expected 48")
    x_std, sort, inf, code = parse_compressed_g1_codes(points)
    for k, message in enumerate(BYTE_ERRORS, 1):
        if (code == k).any():
            raise SerializationError(f"point {int(np.argmax(code == k))}: {message}")
    return x_std, sort, inf


def _ge_const(a: torch.Tensor, value: int) -> torch.Tensor:
    """Lanewise value(a) >= value for canonical standard-form limbs [L, *batch]."""
    borrow = torch.zeros(a.shape[1:], dtype=torch.int64, device=a.device)
    for j in range(a.shape[0]):
        t = (a[j].to(torch.int64) & 0xFFFFFFFF) - ((value >> (32 * j)) & 0xFFFFFFFF) + borrow
        borrow = t >> 32  # 0 or -1
    return borrow == 0


def decompress_g1(x_std: torch.Tensor, sort_bits: torch.Tensor, inf: torch.Tensor):
    """Batched decompression on the tensors' device.

    x_std: [12, N] standard-form x limbs (range-checked by the parser);
    sort_bits, inf: [N] bool. Returns (points G1 [N] Montgomery, on_curve [N],
    in_subgroup [N] bool); identity lanes come back as (0 : 1 : 0) with both
    flags set. CUDA tensors go to the `g1_decompress` kernel, CPU tensors to
    `decompress_g1_plain`; both give the same limbs and flags on every lane.
    """
    if x_std.device.type == "cpu":
        return decompress_g1_plain(x_std, sort_bits, inf)
    x, y, z, on_curve, in_subgroup = K.g1_decompress(x_std, sort_bits, inf)
    return C.G1(x, y, z), on_curve.bool(), in_subgroup.bool()


def decompress_g1_plain(x_std: torch.Tensor, sort_bits: torch.Tensor, inf: torch.Tensor):
    """The plain version of the `g1_decompress` kernel (`decompress_g1` has
    the contract): plain field and group operations, one batched call each,
    on any device, so that on the card it is the reference the kernel is
    held against."""
    mul = F.mont_mul_plain
    batch, dev = x_std.shape[1:], x_std.device
    xm = mul(FP, x_std, FP.broadcast(FP.const(FP.r2_mod_p, dev), batch))
    rhs = mul(FP, xm, mul(FP, xm, xm))
    rhs = F.add(FP, rhs, FP.broadcast(FP.mont_const(B_COEFF, dev), batch))
    y = F.pow_fixed(FP, rhs, _SQRT_EXP, plain=True)
    on_curve = F.equal(FP, mul(FP, y, y), rhs)
    largest = _ge_const(mul(FP, y, FP.broadcast(FP.const(1, dev), batch)), _HALF_P_PLUS_1)
    y = F.select(largest != sort_bits, F.neg(FP, y), y)

    zero = torch.zeros_like(xm)
    one = FP.broadcast(FP.one(dev), batch)
    aff = C.G1Affine(F.select(inf, zero, xm), F.select(inf, zero, y), inf)
    pt = C.G1(aff.x, F.select(inf, one, y), F.select(inf, zero, one))
    phi = C.G1(mul(FP, pt.x, FP.broadcast(FP.mont_const(GLV_BETA, dev), batch)), pt.y, pt.z)
    ladder = C.scalar_mul_static(aff, SUBGROUP_SCALAR, plain=True)
    in_subgroup = C.equal(phi, ladder, plain=True) | inf
    return pt, on_curve | inf, in_subgroup


def raise_for_flags(on_curve, in_subgroup, labels=None) -> None:
    """Raise the reference's errors from fetched flags: the first point not
    on the curve, else the first point outside the subgroup."""
    on_curve = np.asarray(on_curve).astype(bool)
    in_subgroup = np.asarray(in_subgroup).astype(bool)
    if (~on_curve).any():
        idx = int(np.argmax(~on_curve))
        name = labels[idx] if labels is not None else f"point {idx}"
        raise SerializationError(f"{name}: x coordinate not on curve")
    if (~in_subgroup).any():
        idx = int(np.argmax(~in_subgroup))
        name = labels[idx] if labels is not None else f"point {idx}"
        raise SerializationError(f"{name}: point not in the prime-order subgroup")

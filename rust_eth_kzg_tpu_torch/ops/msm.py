"""MSMs on torch: fixed-base over precomputed window tables (Lim-Lee
chains), and variable-base (`lincomb`: Pippenger).

Fixed base: for a fixed point set the table holds, for each point (and each
of `chains` pre-scaled copies of it), the affine multiples d P for
d = 1..2^(w-1). An MSM then takes signed w-bit digits of every scalar, reads
one table entry per (window, point), sums each window's entries with a
chord-addition level and a tree of complete additions, and runs a short
Horner loop over the `wpc` windows of one chain.

Variable base: `pippenger_msm` sorts each window's lanes by bucket with
`torch.argsort`, takes one suffix scan of complete additions over the sorted
points and reads the window sum off the scan (see its docstring);
`lincomb_host`, for scalars known on the host, runs one GLV ladder a lane
and a halving sum.

On CUDA tensors the fixed-base MSM is the `fixed_base_msm` kernel (digits,
table reads, window sums and Horner in one source, `csrc/fixed_base_msm.cu`);
on CPU tensors it is `fixed_base_msm_plain`, the same steps as plain torch,
which is also the kernel's reference on the card. In Pippenger the digits,
sorts, gathers and selects are plain torch and the group operations launch
the CUDA kernels through `ops/curve.py`.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from ..constants import LIMB_BITS, R_SCALAR, SCALAR_BITS
from . import curve as C
from . import field as F
from . import kernels as K

FR = F.FR
FP = F.FP


def scalar_bits_msb(scalars_mont: torch.Tensor, nbits: int | None = None) -> torch.Tensor:
    """Montgomery Fr scalars [L, *batch] -> MSB-first bits [nbits, *batch] bool."""
    if nbits is None:
        nbits = min(SCALAR_BITS - 1, FR.modulus.bit_length())
    std = F.from_mont(FR, scalars_mont)
    rows = [(std[t // LIMB_BITS] >> (t % LIMB_BITS)) & 1 for t in range(nbits - 1, -1, -1)]
    return torch.stack(rows).to(torch.bool)


def signed_digits(scalars_mont: torch.Tensor, window: int, plain: bool = False) -> torch.Tensor:
    """Signed w-bit digits, least significant window first: [n_win, *batch] int64.

    k = sum_t d_t 2^(w t) with d_t in [-2^(w-1), 2^(w-1)];
    n_win = SCALAR_BITS // w + 1 leaves room for the last carry. With `plain`
    the standard form comes from `mont_mul_plain` on any device.
    """
    std = F.from_mont(FR, scalars_mont, plain=plain).to(torch.int64) & 0xFFFFFFFF
    n_win = SCALAR_BITS // window + 1
    half = 1 << (window - 1)
    full = 1 << window
    nbits = 32 * FR.nlimbs
    carry = torch.zeros_like(std[0])
    digits = []
    for t in range(n_win):
        lo = t * window
        u = torch.zeros_like(std[0])
        if lo < nbits:
            limb, off = divmod(lo, 32)
            u = std[limb] >> off
            if off + window > 32 and limb + 1 < FR.nlimbs:
                u = u | (std[limb + 1] << (32 - off))
            u = u & (full - 1)
        e = u + carry
        over = e > half
        digits.append(torch.where(over, e - full, e))
        carry = over.to(torch.int64)
    return torch.stack(digits)


@dataclass(frozen=True)
class FixedBaseMSM:
    """Window tables of a fixed point set.

    table_x, table_y: [12, *instance, chains * P, D] Montgomery Fp limbs of
    the affine multiples d * (2^(window * wpc * j) point_i), d = 1..D
    (D = 2^(window-1)), chain j = 0..chains-1 along the point axis.
    base_inf: [*instance, chains * P] identity mask of the base points (every
    multiple of an identity base point is the identity).
    """

    table_x: torch.Tensor
    table_y: torch.Tensor
    base_inf: torch.Tensor
    window: int
    instance_ndim: int = 0
    chains: int = 1
    wpc: int = 0

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in (self.table_x, self.table_y, self.base_inf))


def slice_instances(tables: FixedBaseMSM, sl: slice) -> FixedBaseMSM:
    """The tables of instances `sl` of the first instance axis, as copies
    (the whole tables can then be freed)."""
    if tables.instance_ndim < 1:
        raise ValueError("these tables have no instance axis")
    return replace(tables, table_x=tables.table_x[:, sl].clone(), table_y=tables.table_y[:, sl].clone(),
                   base_inf=tables.base_inf[sl].clone())


def _assert_no_chord_collision(window: int, wpc: int, chains: int) -> None:
    """Prove the chord addition of the first window-sum level never sees equal points.

    That level pairs (chain c, point p) with (chain c + chains/2, point p):
    the same base point scaled by 2^(window * wpc * chains/2). Those lanes
    are equal iff d1 = +-d2 * 2^(window * wpc * chains/2) (mod r) for digits
    d1, d2 in [1, 2^(window-1)]; check every d2.
    """
    d_max = 1 << (window - 1)
    shift = pow(2, window * wpc * (chains // 2), R_SCALAR)
    for d2 in range(1, d_max + 1):
        t = d2 * shift % R_SCALAR
        if 1 <= t <= d_max or 1 <= R_SCALAR - t <= d_max:
            raise AssertionError(
                f"chord-add collision: d2={d2} maps into the digit range for "
                f"(window={window}, wpc={wpc}, chains={chains})"
            )


def _chain_scaled_points(points: C.G1, chains: int, shift_bits: int) -> C.G1:
    """2^(shift_bits j) * points for j = 0..chains-1, concatenated on the point axis."""
    sets = [points]
    base = points
    for _ in range(chains - 1):
        for _ in range(shift_bits):
            base = C.double(base)
        sets.append(base)
    return C.G1(*(torch.cat([s[i] for s in sets], dim=-1) for i in range(3)))


def _build_tables(points: C.G1, window: int):
    """points [*pts] -> affine multiples 1..2^(w-1) as x, y [12, *pts, D].

    Block doubling: the block of multiples [P, 2P, ..., wP] extends to width
    2w with one batched addition of wP. Built in slices of about 2^20 lanes.
    """
    d = 1 << (window - 1)
    pshape = tuple(points.batch_shape)
    npts = 1
    for s in pshape:
        npts *= s
    flat = C._map(lambda c: c.reshape(FP.nlimbs, npts), points)
    slice_pts = max(1, min(npts, (1 << 20) // d))
    xs, ys, infs = [], [], []
    for s0 in range(0, npts, slice_pts):
        pts = C._map(lambda c: c[:, s0 : s0 + slice_pts], flat)
        block = C._map(lambda c: c[..., None], pts)
        pw = pts
        w = 1
        while w < d:
            ext = C.add(block, C._map(lambda c: c[..., None].expand(c.shape + (w,)), pw))
            block = C._map(lambda b, e: torch.cat((b, e), dim=-1), block, ext)
            w *= 2
            if w < d:
                pw = C.double(pw)
        aff = C.batch_normalize(block)
        xs.append(aff.x)
        ys.append(aff.y)
        infs.append(aff.inf[:, 0])
    x = torch.cat(xs, dim=1).reshape((FP.nlimbs,) + pshape + (d,))
    y = torch.cat(ys, dim=1).reshape((FP.nlimbs,) + pshape + (d,))
    return x, y, torch.cat(infs).reshape(pshape)


def build_fixed_base_msm(
    points: C.G1, window: int, instance_ndim: int = 0, chains: int = 4
) -> FixedBaseMSM:
    """points: G1 with batch shape [*instance, P]."""
    n_win = SCALAR_BITS // window + 1
    wpc = -(-n_win // chains)
    if chains > 1 and chains % 2 == 0:
        _assert_no_chord_collision(window, wpc, chains)
    if chains > 1:
        points = _chain_scaled_points(points, chains, window * wpc)
    x, y, inf = _build_tables(points, window)
    return FixedBaseMSM(x, y, inf, window, instance_ndim, chains, wpc)


def chain_digits(digits: torch.Tensor, chains: int, wpc: int) -> torch.Tensor:
    """Signed digits [n_win, *batch, P] -> the Lim-Lee chain layout
    [wpc, *batch, chains * P]: entry [t, ..., c P + p] is digit c wpc + t of
    scalar p, zero past n_win (chain c's table holds 2^(window wpc c) P)."""
    if chains == 1:
        return digits
    pad = chains * wpc - digits.shape[0]
    digits = torch.cat((digits, torch.zeros_like(digits[:pad])), dim=0)
    dd = digits.reshape((chains, wpc) + digits.shape[1:])
    dd = torch.movedim(dd, 0, -2)  # [wpc, *batch, chains, P]
    return dd.reshape((wpc,) + dd.shape[1:-2] + (chains * dd.shape[-1],))


def _window_sums(tables: FixedBaseMSM, digits: torch.Tensor) -> C.G1:
    """digits [W, *lead, *inst, CP] -> window sums G1 [W, *lead, *inst], by
    the plain formulas on any device."""
    tx, ty = tables.table_x, tables.table_y
    d = tx.shape[-1]
    inst_cp = tuple(tx.shape[1:-1])
    s = 1
    for v in inst_cp:
        s *= v
    rows = torch.arange(s, device=digits.device).reshape(inst_cp) * d
    idx = rows + torch.clamp(digits.abs() - 1, min=0)  # [W, *lead, *inst, CP]
    gx = tx.reshape(FP.nlimbs, s * d)[:, idx]
    gy = ty.reshape(FP.nlimbs, s * d)[:, idx]
    inf = (digits == 0) | tables.base_inf
    gy = F.select(digits < 0, F.neg(FP, gy), gy)
    k = gx.shape[-1]
    if k % 2 == 0 and k > 1:
        h = k // 2
        lo = C.G1Affine(gx[..., :h], gy[..., :h], inf[..., :h])
        hi = C.G1Affine(gx[..., h:], gy[..., h:], inf[..., h:])
        proj = C.add_affine_plain(lo, hi)
    else:
        one = FP.broadcast(FP.one(gx.device), gx.shape[1:])
        zero = torch.zeros_like(gx)
        proj = C.G1(F.select(inf, zero, gx), F.select(inf, one, gy), F.select(inf, zero, one))
    return C.reduce_sum(proj, axis=-1, plain=True)


def fixed_base_msm_plain(tables: FixedBaseMSM, scalars_mont: torch.Tensor) -> C.G1:
    """`fixed_base_msm` as plain torch on any device: the signed digits in the
    chain layout, one table entry per (window, lane), the window sums (a chord
    level and a halving tree) and Horner over the `wpc` windows, most
    significant first, with the plain formulas (`add_affine_plain`,
    `reduce_sum(plain=True)`, `double_plain`, `add_plain`). The route for CPU
    tensors and the kernel's reference on the card."""
    w = tables.window
    digits = chain_digits(signed_digits(scalars_mont, w, plain=True), tables.chains, tables.wpc)
    n_win = digits.shape[0]
    wsums = _window_sums(tables, digits)  # [n_win, *batch]
    acc = C._map(lambda c: c[:, n_win - 1], wsums)
    for t in range(n_win - 2, -1, -1):
        for _ in range(w):
            acc = C.double_plain(acc)
        acc = C.add_plain(acc, C._map(lambda c: c[:, t], wsums))
    return acc


def fixed_base_msm(tables: FixedBaseMSM, scalars_mont: torch.Tensor) -> C.G1:
    """sum_i k_i P_i over the table's point set.

    scalars_mont: [8, *batch, P] with P the table's point count (the trailing
    batch axes align with the table's instance axes). Returns G1 [*batch].
    CPU tensors run `fixed_base_msm_plain`, CUDA tensors the `fixed_base_msm`
    kernel.
    """
    if scalars_mont.device.type == "cpu":
        return fixed_base_msm_plain(tables, scalars_mont)
    return C.G1(*K.fixed_base_msm(tables.table_x, tables.table_y, tables.base_inf, scalars_mont,
                                  tables.window, tables.chains, tables.wpc))


# --- variable-base MSM ---


def _incl_scan_add(p: C.G1) -> C.G1:
    """Inclusive prefix scan of group addition along the last axis (a power
    of two): add adjacent pairs, scan the half-length array, then fix up the
    even positions; 2 n complete additions at halving widths."""
    n = p.x.shape[-1]
    if n == 1:
        return p
    even = C._map(lambda c: c[..., 0::2], p)
    odd = C._map(lambda c: c[..., 1::2], p)
    s = _incl_scan_add(C.add(even, odd))  # [..., n/2] pair-inclusive sums
    idp = C.identity(p.batch_shape[:-1] + (1,), p.device)
    sprev = C._map(lambda i, c: torch.cat((i, c[..., :-1]), dim=-1), idp, s)
    out_even = C.add(sprev, even)
    return C._map(lambda ce, co: torch.stack((ce, co), dim=-1).reshape(ce.shape[:-1] + (n,)), out_even, s)


def _gather_last(c: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """c [L, *batch, M], idx [*batch, K] -> c[:, ..., idx] [L, *batch, K]."""
    return torch.gather(c, -1, idx[None].expand((c.shape[0],) + tuple(idx.shape)))


def pippenger_msm(points: C.G1, scalars_mont: torch.Tensor, window: int = 8) -> C.G1:
    """Variable-base MSM sum_i k_i P_i by signed-window buckets.

    points: G1 [*batch, N]; scalars_mont: [8, *batch, N]. Returns G1 [*batch].
    1. signed w-bit digits of every scalar (`signed_digits`), h = 2^(w-1);
    2. per window, each lane's signed point (y negated where d < 0, the
       identity where d = 0) and bucket |d| - 1, or h for a zero digit (and
       for the identity lanes that pad N to a power of two);
    3. `torch.argsort` of the buckets, and one gather into sorted order;
    4. one suffix scan T[i] = sum_{j >= i} sorted[j] (`_incl_scan_add` on the
       reversed lanes), with T[pow2] = the identity for empty suffixes;
    5. the window sum sum_b (b + 1) bucket_b = sum_{j < h} T[start_j], with
       start_j the number of lanes whose bucket is below j: one gather of T
       at the h starts and a tree sum;
    6. Horner over the windows, most significant first.
    """
    digits = signed_digits(scalars_mont, window)  # [W, *batch, N]
    n_win = digits.shape[0]
    h = 1 << (window - 1)
    n = points.x.shape[-1]
    pow2 = 1 << max(n - 1, 0).bit_length()
    device = points.device

    shape = (FP.nlimbs,) + tuple(digits.shape)
    bx, by, bz = (c[:, None].expand(shape) for c in points)
    neg_mask = digits < 0
    zero_mask = digits == 0
    by = F.select(neg_mask, F.neg(FP, by), by)
    one = FP.broadcast(FP.one(device), digits.shape)
    zero = torch.zeros(shape, dtype=torch.int32, device=device)
    bx = F.select(zero_mask, zero, bx)
    by = F.select(zero_mask, one, by)
    bz = F.select(zero_mask, zero, bz)
    b_idx = torch.where(zero_mask, h, digits.abs() - 1)  # [W, *batch, N]
    if pow2 != n:
        pad = pow2 - n
        pad_pt = C.identity(tuple(digits.shape[:-1]) + (pad,), device)
        bx, by, bz = (torch.cat((c, i), dim=-1) for c, i in zip((bx, by, bz), pad_pt))
        b_idx = torch.cat((b_idx, torch.full(b_idx.shape[:-1] + (pad,), h, dtype=b_idx.dtype, device=device)), dim=-1)
    order = torch.argsort(b_idx, dim=-1, stable=True)
    srt = C.G1(*(_gather_last(c, order) for c in (bx, by, bz)))
    pre = _incl_scan_add(C._map(lambda c: torch.flip(c, (-1,)), srt))  # pre[i] = sum of the last i + 1
    t_scan = C._map(lambda c: torch.flip(c, (-1,)), pre)  # T[i] = sum_{j >= i}
    idp = C.identity(t_scan.batch_shape[:-1] + (1,), device)
    t_scan = C._map(lambda c, i: torch.cat((c, i), dim=-1), t_scan, idp)

    counts = (b_idx[..., None] == torch.arange(h, device=device)).sum(dim=-2)  # [W, *batch, h]
    start = torch.cumsum(counts, dim=-1) - counts
    wsums = C.reduce_sum(C.G1(*(_gather_last(c, start) for c in t_scan)), axis=-1)  # [W, *batch]

    acc = C._map(lambda c: c[:, n_win - 1], wsums)
    for t in range(n_win - 2, -1, -1):
        for _ in range(window):
            acc = C.double(acc)
        acc = C.add(acc, C._map(lambda c: c[:, t], wsums))
    return acc


def lincomb(points: C.G1, scalars_mont: torch.Tensor) -> C.G1:
    """Variable-base MSM sum_i k_i P_i over the last axis, by Pippenger with
    window min(8, max(4, bit_length(N) - 4)).

    points: G1 [*batch, N]; scalars_mont: [8, *batch, N]. Identity points and
    zero scalars need no filtering: they contribute the identity.
    """
    n = points.x.shape[-1]
    return pippenger_msm(points, scalars_mont, min(8, max(4, n.bit_length() - 4)))


def lincomb_host(points: C.G1, scalars, plain: bool = False) -> C.G1:
    """Variable-base MSM sum_i k_i P_i over the last axis, for scalars that
    are host integers (the EIP-4844 batch verifier): each lane's GLV split
    (`curve.glv_digits_host`) and ladder (`curve.scalar_mul_glv`: on CUDA
    tensors the `g1_add` and `g1_double` kernels), then `curve.reduce_sum`.

    points: G1 [*batch, N]; scalars: ints nested as [*batch][N] (any values:
    reduced mod r). Returns G1 [*batch]. An identity point or a zero scalar
    contributes the identity. With `plain` the plain formulas run on any
    device: the reference of the kernels' route on the card.
    """
    batch = tuple(points.batch_shape)
    flat = np.asarray(scalars, dtype=object).reshape(-1)
    if flat.shape[0] != points.x[0].numel():
        raise ValueError(f"lincomb_host: {flat.shape[0]} scalars for points of shape {batch}")
    digits, neg1, neg2 = C.glv_digits_host([int(k) for k in flat])
    dev = points.device
    digits = torch.from_numpy(digits).to(dev).reshape((digits.shape[0],) + batch)
    neg1, neg2 = (torch.from_numpy(a).to(dev).reshape(batch) for a in (neg1, neg2))
    per_point = C.scalar_mul_glv(points, digits, neg1, neg2, plain=plain)
    return C.reduce_sum(per_point, axis=-1, plain=plain)

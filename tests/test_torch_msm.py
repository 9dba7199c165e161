"""Port MSMs (rust_eth_kzg_tpu_torch.ops.msm, CPU plain versions).

signed_digits and the chord-collision guard are compared
exactly with the JAX package; fixed_base_msm is held against a host
double-and-add MSM, as tests/test_msm.py holds the JAX one (the JAX table
build takes minutes to compile on the CPU; its tables are compared with the
port's at the FK20 test geometry in test_torch_fk20.py). The variable-base
MSMs run at the tests/test_msm.py shapes against JAX's compiled graphs
(Pippenger at N = 64, window 4; lincomb at N = 5, a bit ladder in JAX and
Pippenger in the port) and against
a host oracle: the points are multiples a_i Q of one point with known a_i,
so sum k_i P_i = (sum k_i a_i) Q costs one host multiplication.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_eth_kzg_tpu.ops import curve as JC
from rust_eth_kzg_tpu.ops import field as JF
from rust_eth_kzg_tpu.ops import msm as JM
from rust_eth_kzg_tpu_torch.constants import R_SCALAR
from rust_eth_kzg_tpu_torch.ops import curve as C
from rust_eth_kzg_tpu_torch.ops import field as F
from rust_eth_kzg_tpu_torch.ops import kernels as K
from rust_eth_kzg_tpu_torch.ops import msm as M
from rust_eth_kzg_tpu_torch.utils import bls_host as B
from rust_eth_kzg_tpu_torch.utils.edge_inputs import msm_scalars

# One intra-op thread: the plain versions run many small tensor ops, and
# beside other busy processes (xdist workers, XLA compiles) a thread pool
# stalls each op until all its threads are scheduled.
torch.set_num_threads(1)

FR = F.FR
SPECIAL = [0, 1, R_SCALAR - 1, (1 << 255) % R_SCALAR]


def _scalars(n, seed):
    rng = np.random.default_rng(seed)
    return [int(v) ** 5 % R_SCALAR for v in rng.integers(1, 2**62, size=n)]


@pytest.mark.parametrize("window", [4, 8])
def test_signed_digits_match_jax(window):
    ks = SPECIAL + _scalars(12, window)
    got = M.signed_digits(torch.from_numpy(FR.to_mont_host(ks)), window).numpy()
    want = np.asarray(JM.signed_digits(jnp.asarray(JF.FR.to_mont_host(ks)), window))
    assert np.array_equal(got, want)
    for i, k in enumerate(ks):
        assert sum(int(got[t, i]) << (window * t) for t in range(got.shape[0])) == k
    assert np.abs(got).max() <= 1 << (window - 1)


@pytest.mark.parametrize("window,chains", [(w, c) for w in range(2, 9) for c in (2, 4)])
def test_chord_collision_guard_matches_jax(window, chains):
    wpc = -(-(256 // window + 1) // chains)

    def outcome(fn):
        try:
            fn(window, wpc, chains)
        except AssertionError:
            return "collision"
        return "ok"

    assert outcome(M._assert_no_chord_collision) == outcome(JM._assert_no_chord_collision)


def _naive_msm(points, scalars):
    acc = None
    for p, k in zip(points, scalars):
        if p is not None:
            acc = B.g1_add(acc, B.g1_mul(p, k))
    return acc


def test_fixed_base_msm_matches_host():
    rng = np.random.default_rng(1)
    pts = [B.g1_mul(B.G1_GEN, int(rng.integers(1, 2**62))) for _ in range(8)]
    pts[3] = None  # identity base point
    scalars = _scalars(8, 2)
    scalars[1] = 0
    scalars[5] = R_SCALAR - 1
    tables = M.build_fixed_base_msm(C.points_to_device(pts, "cpu"), window=4)
    assert tables.base_inf.tolist() == [p is None for p in pts] * 4  # one copy per chain
    got = C.points_from_device(M.fixed_base_msm(tables, torch.from_numpy(FR.to_mont_host(scalars))))
    assert got[0] == _naive_msm(pts, scalars)


def test_fixed_base_msm_instances_and_batch():
    """Two MSM instances (the FK20 slot axis) under a batch of 2 scalar sets."""
    rng = np.random.default_rng(3)
    pts = [B.g1_mul(B.G1_GEN, int(rng.integers(1, 2**62))) for _ in range(8)]
    dev = C._map(lambda c: c.reshape(12, 2, 4), C.points_to_device(pts, "cpu"))
    tables = M.build_fixed_base_msm(dev, window=4, instance_ndim=1, chains=2)
    assert tables.table_x.shape == (12, 2, 8, 8)
    scalars = _scalars(16, 4)
    sm = torch.from_numpy(FR.to_mont_host(scalars)).reshape(FR.nlimbs, 2, 2, 4)
    got = C.points_from_device(M.fixed_base_msm(tables, sm))
    want = [
        _naive_msm(pts[4 * i : 4 * i + 4], scalars[8 * b + 4 * i : 8 * b + 4 * i + 4])
        for b in range(2)
        for i in range(2)
    ]
    assert got == want


def _instance_tables(seed, identity_lane=2):
    """Window-4 tables of 2 instances x 4 points, 2 chains, one identity base
    point; the host points too."""
    rng = np.random.default_rng(seed)
    pts = [B.g1_mul(B.G1_GEN, int(rng.integers(1, 2**62))) for _ in range(8)]
    pts[identity_lane] = None
    dev = C._map(lambda c: c.reshape(12, 2, 4), C.points_to_device(pts, "cpu"))
    return M.build_fixed_base_msm(dev, window=4, instance_ndim=1, chains=2), pts


def test_fixed_base_msm_plain_matches_dispatch_and_host():
    """fixed_base_msm_plain equals fixed_base_msm on CPU tensors limb for
    limb, and the host oracle: window 4, 2 instances, chains 2, an identity
    base point; zero scalars, r - 1 and an all-zero batch row. No kernel."""
    tables, pts = _instance_tables(11)
    assert bool(tables.base_inf.any())
    sm = torch.from_numpy(msm_scalars((3, 2, 4), 12))
    ks = FR.from_mont_host(sm.reshape(FR.nlimbs, -1).numpy())
    assert 0 in ks and R_SCALAR - 1 in ks and ks[:8] == [0] * 8
    before = dict(K.LAUNCHES)
    plain = M.fixed_base_msm_plain(tables, sm)
    got = M.fixed_base_msm(tables, sm)
    assert dict(K.LAUNCHES) == before
    assert all(torch.equal(g, w) for g, w in zip(got, plain))
    want = [_naive_msm(pts[4 * i : 4 * i + 4], ks[8 * b + 4 * i : 8 * b + 4 * i + 4]) for b in range(3) for i in range(2)]
    assert C.points_from_device(plain) == want


@pytest.mark.parametrize("window,chains", [(4, 2), (8, 4), (5, 1)])
def test_chain_digits_layout(window, chains):
    """The chain layout: the reshape of the signed digits, and entry
    [t, ..., c P + p] == digit c wpc + t of scalar p (zero past n_win), the
    index the fixed_base_msm kernel computes."""
    n_win = 256 // window + 1
    wpc = -(-n_win // chains)
    sm = torch.from_numpy(msm_scalars((2, 3), 13))
    digits = M.signed_digits(sm, window)
    got = M.chain_digits(digits, chains, wpc)
    assert got.shape == (wpc, 2, chains * 3)
    for t in range(wpc):
        for c in range(chains):
            wi = c * wpc + t
            want = digits[wi] if wi < n_win else torch.zeros_like(digits[0])
            assert torch.equal(got[t, :, c * 3 : c * 3 + 3], want)


def _kernel_digit(k, wi, window):
    """Signed digit wi of k as the kernel makes it: 32-bit limbs, the window's
    bits from one or two limbs, the carry loop over windows 0..wi."""
    limbs = [(k >> (32 * i)) & 0xFFFFFFFF for i in range(8)]
    half, full = 1 << (window - 1), 1 << window
    carry = d = 0
    for q in range(wi + 1):
        lo, u = q * window, 0
        if lo < 256:
            limb, off = lo >> 5, lo & 31
            bits = limbs[limb] >> off
            if off + window > 32 and limb + 1 < 8:
                bits |= (limbs[limb + 1] << (32 - off)) & 0xFFFFFFFF
            u = bits & (full - 1)
        e = u + carry
        carry = int(e > half)
        d = e - full if carry else e
    return d


def _kernel_schedule(tables, sm, per_block):
    """The fixed_base_msm kernel's schedule with the plain formulas: for each
    (output point o, window slot t, split g) block, the post-chord points
    j = g + G k from lanes j and j + M (digit (l / P) wpc + t of scalar
    o P + l % P, entry (inst K + l) D + |d| - 1, y negated for d < 0, identity
    for d = 0 or an identity base point), halving within the block, halving
    over the G partials, then Horner; at most per_block points a block."""
    w, chains, wpc = tables.window, tables.chains, tables.wpc
    inst = tuple(tables.table_x.shape[1:-2])
    cp, d = tables.table_x.shape[-2:]
    p_ = cp // chains
    n_inst = int(np.prod(inst))
    n_win = 256 // w + 1
    ks = FR.from_mont_host(sm.reshape(FR.nlimbs, -1).numpy())
    n_out = len(ks) // p_
    chord, m, s, g = K.fixed_base_split(cp, per_block)
    tx = tables.table_x.reshape(12, -1)
    ty = tables.table_y.reshape(12, -1)
    inf_base = tables.base_inf.reshape(-1).tolist()
    entry, neg, inf = [], [], []
    for o in range(n_out):
        for t in range(wpc):
            for gi in range(g):
                for k in range(s):
                    j = gi + g * k
                    for l in ((j, j + m) if chord else (j,)):
                        wi = (l // p_) * wpc + t
                        dig = _kernel_digit(ks[o * p_ + l % p_], wi, w) if wi < n_win and j < m else 0
                        row = (o % n_inst) * cp + l
                        entry.append(row * d + max(abs(dig) - 1, 0) if j < m else 0)
                        neg.append(dig < 0)
                        inf.append(dig == 0 or bool(inf_base[row]) if j < m else True)
    idx = torch.tensor(entry)
    gx, gy = tx[:, idx], ty[:, idx]
    neg, inf = torch.tensor(neg), torch.tensor(inf)
    gy = F.select(neg, F.neg(F.FP, gy), gy)
    if chord:
        a = C.G1Affine(gx[:, 0::2], gy[:, 0::2], inf[0::2])
        b = C.G1Affine(gx[:, 1::2], gy[:, 1::2], inf[1::2])
        pts = C.add_affine_plain(a, b)
    else:
        one = F.FP.broadcast(F.FP.one("cpu"), inf.shape)
        pts = C.G1(F.select(inf, torch.zeros_like(gx), gx), F.select(inf, one, gy), F.select(inf, torch.zeros_like(gx), one))
    pts = C._map(lambda c: c.reshape(12, n_out * wpc * g, s), pts)
    n = s
    while n > 1:  # within each block
        h = n // 2
        pts = C.add_plain(C._map(lambda c: c[..., :h], pts), C._map(lambda c: c[..., h:], pts))
        n = h
    pts = C._map(lambda c: c.reshape(12, n_out, wpc, g), pts)
    while g > 1:  # over the partials
        h = g // 2
        pts = C.add_plain(C._map(lambda c: c[..., :h], pts), C._map(lambda c: c[..., h:], pts))
        g = h
    acc = C._map(lambda c: c[:, :, wpc - 1, 0], pts)
    for t in range(wpc - 2, -1, -1):
        for _ in range(w):
            acc = C.double_plain(acc)
        acc = C.add_plain(acc, C._map(lambda c: c[:, :, t, 0], pts))
    return C._map(lambda c: c.reshape((12,) + tuple(sm.shape[1:-1])), acc)


@pytest.mark.parametrize("per_block", [128, 2])
def test_kernel_schedule_matches_plain(per_block):
    """The kernel's digits, entry indices, block split and summation order
    equal fixed_base_msm_plain limb for limb: window 4, 2 instances, chains
    2, an identity base point, a batch of 2 with an all-zero row; with 2
    points a block the window sums split over G = 2 blocks and a second
    halving."""
    tables, _ = _instance_tables(14, identity_lane=5)
    sm = torch.from_numpy(msm_scalars((2, 2, 4), 15))
    assert K.fixed_base_split(8, per_block) == ((1, 4, 4, 1) if per_block == 128 else (1, 4, 2, 2))
    got = _kernel_schedule(tables, sm, per_block)
    want = M.fixed_base_msm_plain(tables, sm)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("k", [1, 3, 8, 20, 256, 300, 16384])
def test_fixed_base_split(k):
    """The split of a window sum of k lanes: the chord level for even k > 1,
    at most 128 points a block, G blocks covering the padded points."""
    chord, m, s, g = K.fixed_base_split(k)
    assert chord == (k % 2 == 0 and k > 1) and m == (k // 2 if chord else k)
    mp = s * g
    assert mp >= m > mp // 2 or mp == m == 1
    assert s == min(mp, 128) and mp & (mp - 1) == 0


def test_fixed_base_msm_wrapper_takes_cuda_tensors_only():
    tables, _ = _instance_tables(16)
    sm = torch.from_numpy(msm_scalars((1, 2, 4), 17))
    with pytest.raises(ValueError):
        K.fixed_base_msm(tables.table_x, tables.table_y, tables.base_inf, sm, 4, 2, tables.wpc)
    assert K.LAUNCHES["fixed_base_msm"] == 0


def _multiples(n, seed):
    """Points a_i Q (i < n) with their a_i: Q a random point, a_i = i + 1,
    lane 5 the identity (a = 0) and lane 6 a copy of lane 9."""
    rng = np.random.default_rng(seed)
    q = B.g1_mul(B.G1_GEN, int(rng.integers(1, 2**62)))
    pts, acc = [], None
    for _ in range(n):
        acc = B.g1_add(acc, q)
        pts.append(acc)
    a = list(range(1, n + 1))
    pts[5], a[5] = None, 0
    pts[6], a[6] = pts[9], a[9]
    return pts, a, q


def _oracle(q, a, ks):
    return B.g1_mul(q, sum(x * k for x, k in zip(a, ks)))


def test_pippenger_matches_jax():
    """N = 64, window 4: one MSM against JAX's pippenger_msm, and the
    verifier's batched [3, N] shape (the same points, three scalar sets)
    against the host oracle. Zero scalars, r - 1 and 2^255 mod r included."""
    pts, a, q = _multiples(64, 6)
    rows = [_scalars(64, 7 + i) for i in range(3)]
    rows[0][:4] = SPECIAL
    rows[1][10:20] = [0] * 10
    dev = C.points_to_device(pts, "cpu")
    got = C.points_from_device(M.pippenger_msm(dev, torch.from_numpy(FR.to_mont_host(rows[0])), 4))
    want = JC.points_from_device(JM.pippenger_msm(JC.points_to_device(pts), jnp.asarray(JF.FR.to_mont_host(rows[0])), 4))
    assert got == want == [_oracle(q, a, rows[0])]
    pts3 = C._map(lambda c: c[:, None].expand(12, 3, 64).contiguous(), dev)
    scal3 = torch.from_numpy(FR.to_mont_host([k for r in rows for k in r])).reshape(FR.nlimbs, 3, 64)
    got3 = C.points_from_device(M.pippenger_msm(pts3, scal3, 4))
    assert got3 == [_oracle(q, a, r) for r in rows]


@pytest.mark.parametrize("n, window", [(20, 5), (3, 4), (1, 4)])
def test_pippenger_pads_to_a_power_of_two(n, window):
    pts, a, q = _multiples(20, 8)
    pts, a = pts[:n], a[:n]
    ks = _scalars(n, 9)
    got = C.points_from_device(M.pippenger_msm(C.points_to_device(pts, "cpu"), torch.from_numpy(FR.to_mont_host(ks)), window))
    assert got == [_oracle(q, a, ks)]


def test_lincomb_matches_jax():
    """N = 5: Pippenger in the port, the bit ladder in JAX (which runs
    Pippenger from 64 points on); the same point."""
    pts, a, q = _multiples(10, 10)
    pts, a = pts[3:8], a[3:8]  # the identity lane 5 and the duplicate lane 6 inside
    ks = _scalars(5, 11)
    ks[4] = 0
    got = C.points_from_device(M.lincomb(C.points_to_device(pts, "cpu"), torch.from_numpy(FR.to_mont_host(ks))))
    want = JC.points_from_device(JM.lincomb(JC.points_to_device(pts), jnp.asarray(JF.FR.to_mont_host(ks))))
    assert got == want == [_oracle(q, a, ks)]


def test_lincomb_window(monkeypatch):
    """Pippenger for every N, with window min(8, max(4, bit_length - 4))."""
    seen = []
    monkeypatch.setattr(M, "pippenger_msm", lambda p, s, w: seen.append((p.x.shape[-1], w)))
    for n in (5, 63, 64, 128, 1024, 4096, 8192):
        p = C.identity((n,), "cpu")
        M.lincomb(p, torch.zeros((FR.nlimbs, n), dtype=torch.int32))
    assert seen == [(5, 4), (63, 4), (64, 4), (128, 4), (1024, 7), (4096, 8), (8192, 8)]

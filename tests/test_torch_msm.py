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
from rust_eth_kzg_tpu_torch.ops import msm as M
from rust_eth_kzg_tpu_torch.utils import bls_host as B

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

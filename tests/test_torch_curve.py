"""Port G1 arithmetic (rust_eth_kzg_tpu_torch.ops.curve, CPU plain versions)
against the JAX package on the same points.

add / double / add_affine run the same formulas with exact modular
arithmetic in both packages, so the canonical projective coordinates agree
exactly, not only the points. The JAX bodies run eagerly (jit disabled):
compiled, each costs seconds on the CPU. scalar_mul_glv is held against the
host oracle instead: the JAX GLV ladder takes minutes to compile here.
add_mixed is compared coordinate for coordinate; scalar_mul_static runs
another representative of the same point (the port skips the additions of
zero bits), so it is compared after normalization.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from rust_eth_kzg_tpu.ops import curve as JC
from rust_eth_kzg_tpu.ops import limbs as JL
from rust_eth_kzg_tpu_torch.constants import BLS_X, GLV_BETA, P, R_SCALAR
from rust_eth_kzg_tpu_torch.ops import curve as C
from rust_eth_kzg_tpu_torch.ops import field as F
from rust_eth_kzg_tpu_torch.utils import bls_host as B
from rust_eth_kzg_tpu_torch.utils import convert

# One intra-op thread: the plain versions run many small tensor ops, and
# beside other busy processes (xdist workers, XLA compiles) a thread pool
# stalls each op until all its threads are scheduled.
torch.set_num_threads(1)

FP = F.FP


def _points(n, seed):
    rng = np.random.default_rng(seed)
    return [B.g1_mul(B.G1_GEN, int(rng.integers(1, 2**62))) for _ in range(n)]


def _projective(pts, seed):
    """Host points -> projective (X, Y, Z) ints, each lane scaled by a random
    lambda; lanes 0-2 are scaled so that X, Y, Z hit p - 1."""
    rng = np.random.default_rng(seed)
    out = []
    for i, pt in enumerate(pts):
        if pt is None:
            out.append((0, 1, 0))
            continue
        x, y = pt
        lam = int(rng.integers(1, 2**62)) * 0x1234567 % P or 1
        if i == 0:
            lam = (P - 1) * pow(x, -1, P) % P
        elif i == 1:
            lam = (P - 1) * pow(y, -1, P) % P
        elif i == 2:
            lam = P - 1
        out.append((x * lam % P, y * lam % P, lam))
    return out


def _port_g1(proj):
    return C.G1(*(torch.from_numpy(FP.to_mont_host([c[i] for c in proj])) for i in range(3)))


def _jax_g1(proj):
    return JC.G1(*(jnp.asarray(JC.FP.to_mont_host([c[i] for c in proj])) for i in range(3)))


def _port_coords(p):
    return [FP.from_mont_host(c.reshape(FP.nlimbs, -1).numpy()) for c in p]


def _jax_coords(p):
    return [JC.FP.from_mont_host(np.asarray(c).reshape(c.shape[0], -1)) for c in p]


def _pairs():
    a = _points(12, 1)
    b = _points(12, 2)
    a[3] = None  # identity lanes
    b[4] = None
    b[5] = a[5]  # doubling lane through the complete adder
    b[6] = B.g1_neg(a[6])  # inverse lane
    return a, b


def test_add_matches_jax():
    a, b = _pairs()
    pa, pb = _projective(a, 3), _projective(b, 4)
    got = C.add(_port_g1(pa), _port_g1(pb))
    with jax.disable_jit():
        want = JC.add_values(_jax_g1(pa), _jax_g1(pb))
    assert _port_coords(got) == _jax_coords(want)
    assert C.points_from_device(got) == [B.g1_add(x, y) for x, y in zip(a, b)]


def test_double_matches_jax():
    a, _ = _pairs()
    pa = _projective(a, 5)
    got = C.double(_port_g1(pa))
    with jax.disable_jit():
        want = JC.double_values(_jax_g1(pa))
    assert _port_coords(got) == _jax_coords(want)
    assert C.points_from_device(got) == [B.g1_add(x, x) for x in a]


def test_add_affine_matches_jax():
    a, b = _pairs()
    inf_a = [p is None for p in a]
    inf_b = [p is None for p in b]
    xa = [0 if p is None else p[0] for p in a]
    ya = [0 if p is None else p[1] for p in a]
    xb = [0 if p is None else p[0] for p in b]
    yb = [0 if p is None else p[1] for p in b]
    port = C.add_affine(
        C.G1Affine(torch.from_numpy(FP.to_mont_host(xa)), torch.from_numpy(FP.to_mont_host(ya)), torch.tensor(inf_a)),
        C.G1Affine(torch.from_numpy(FP.to_mont_host(xb)), torch.from_numpy(FP.to_mont_host(yb)), torch.tensor(inf_b)),
    )
    with jax.disable_jit():
        want = JC.add_affine_values(
            JC.G1Affine(jnp.asarray(JC.FP.to_mont_host(xa)), jnp.asarray(JC.FP.to_mont_host(ya)), jnp.asarray(inf_a)),
            JC.G1Affine(jnp.asarray(JC.FP.to_mont_host(xb)), jnp.asarray(JC.FP.to_mont_host(yb)), jnp.asarray(inf_b)),
        )
    # identical canonical coordinates in every lane, the equal-input lane's
    # invalid (0 : 0 : 0) included
    assert _port_coords(port) == _jax_coords(want)
    got = C.points_from_device(port)
    for i, (x, y) in enumerate(zip(a, b)):
        if i != 5:
            assert got[i] == B.g1_add(x, y)


def _affine(pts):
    xs = [0 if p is None else p[0] for p in pts]
    ys = [0 if p is None else p[1] for p in pts]
    inf = [p is None for p in pts]
    port = C.G1Affine(torch.from_numpy(FP.to_mont_host(xs)), torch.from_numpy(FP.to_mont_host(ys)), torch.tensor(inf))
    jax_q = JC.G1Affine(jnp.asarray(JC.FP.to_mont_host(xs)), jnp.asarray(JC.FP.to_mont_host(ys)), jnp.asarray(inf))
    return port, jax_q


def test_add_mixed_matches_jax():
    """Identity p lanes, identity q lanes, p == q (the complete formula
    doubles) and p == -q lanes."""
    a, b = _pairs()
    b[7] = a[7]
    pa = _projective(a, 18)
    q, jq = _affine(b)
    got = C.add_mixed(_port_g1(pa), q)
    with jax.disable_jit():
        want = JC.add_mixed_values(_jax_g1(pa), jq)
    assert _port_coords(got) == _jax_coords(want)
    assert C.points_from_device(got) == [B.g1_add(x, y) for x, y in zip(a, b)]


def test_scalar_mul_static_matches_jax():
    """The subgroup check's ladder, k = z^2 - 1 (128 bits, 48 of them set),
    against JAX's compiled scalar_mul_static (its eager scan takes minutes
    on an 8-core CPU) and the host oracle."""
    k = BLS_X**2 - 1
    pts = _points(4, 19)
    pts[1] = None
    q, _ = _affine(pts)
    got = C.points_from_device(C.scalar_mul_static(q, k))
    want = JC.points_from_device(JC.scalar_mul_static(JC.points_to_device(pts), k))
    assert got == want == [None if p is None else B.g1_mul_unreduced(p, k) for p in pts]


def test_affine_to_device_round_trip():
    pts = _points(3, 22) + [None]
    aff = C.affine_to_device(pts, "cpu")
    assert aff.inf.tolist() == [False, False, False, True]
    assert C.affine_from_device(aff) == pts


def test_batch_normalize_matches_jax():
    a, _ = _pairs()
    pa = _projective(a, 6)
    got = C.batch_normalize(_port_g1(pa))
    want = JC.batch_normalize(_jax_g1(pa))
    assert got.inf.tolist() == np.asarray(want.inf).tolist()
    assert FP.from_mont_host(got.x.numpy()) == JC.FP.from_mont_host(np.asarray(want.x))
    assert FP.from_mont_host(got.y.numpy()) == JC.FP.from_mont_host(np.asarray(want.y))
    assert C.affine_from_device(got) == a


def test_neg_select_equal_identity():
    a, _ = _pairs()
    p = _port_g1(_projective(a, 7))
    q = _port_g1(_projective(a, 8))  # the same points, other coordinates
    assert C.equal(p, q).all()
    assert C.is_identity(p).tolist() == [x is None for x in a]
    assert C.points_from_device(C.neg(p)) == [B.g1_neg(x) for x in a]
    assert C.equal(C.add(p, C.neg(q)), C.identity((12,), "cpu")).all()
    cond = torch.arange(12) % 2 == 0
    sel = C.points_from_device(C.select(cond, p, C.identity((12,), "cpu")))
    assert sel == [x if i % 2 == 0 else None for i, x in enumerate(a)]


def test_reduce_sum_matches_host():
    a, _ = _pairs()
    p = _port_g1(_projective(a[:11], 9))  # 11 lanes: padded to 16 with the identity
    want = None
    for x in a[:11]:
        want = B.g1_add(want, x)
    assert C.points_from_device(C.reduce_sum(p))[0] == want


def test_glv_decompose_matches_jax():
    rng = np.random.default_rng(10)
    ks = [0, 1, R_SCALAR - 1, (1 << 255) % R_SCALAR] + [int(rng.integers(0, 2**63)) ** 4 % R_SCALAR for _ in range(20)]
    for k in ks:
        assert C.glv_decompose(k) == JC.glv_decompose(k)
    got = C.glv_bits_host(ks)
    want = JC.glv_bits_host(ks)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


def test_scalar_mul_glv_matches_host():
    a = _points(6, 11)
    a[2] = None
    rng = np.random.default_rng(12)
    ks = [0, 1, R_SCALAR - 1, int(rng.integers(0, 2**63)) ** 4 % R_SCALAR, 7, 2**200 + 3]
    digits, n1, n2 = (torch.from_numpy(t) for t in C.glv_digits_host(ks))
    got = C.points_from_device(C.scalar_mul_glv(_port_g1(_projective(a, 13)), digits, n1, n2))
    assert got == [B.g1_mul(x, k) if x is not None else None for x, k in zip(a, ks)]
    assert C.points_from_device(C.glv_endomorphism(C.points_to_device(a, "cpu"))) == [
        None if x is None else (x[0] * GLV_BETA % P, x[1]) for x in a
    ]


def test_add_double_on_lazy_jax_points():
    """JAX points with every coordinate lifted toward its documented < 4p
    bound (tests/test_bounds.py), carried over by utils/convert.py: the port's
    add and double give the JAX package's canonical coordinates."""
    a, b = _pairs()
    rng = np.random.default_rng(15)

    def lifted(proj):
        cols = []
        for i in range(3):
            mont = [c[i] * JC.FP.r_mod_p % P for c in proj]
            cols.append([r + int(k) * P for r, k in zip(mont, rng.integers(0, 4, size=len(mont)))])
        return JC.G1(*(jnp.asarray(JL.ints_to_limbs(c, JC.FP.nlimbs)) for c in cols))

    ja, jb = lifted(_projective(a, 16)), lifted(_projective(b, 17))
    assert max(v for c in (*ja, *jb) for v in JL.limbs_to_ints(np.asarray(c))) >= 3 * P
    pa = convert.g1_from_jax(*(np.asarray(c) for c in ja), "cpu")
    pb = convert.g1_from_jax(*(np.asarray(c) for c in jb), "cpu")
    with jax.disable_jit():
        want_add = JC.add_values(ja, jb)
        want_double = JC.double_values(ja)
    assert _port_coords(C.add(pa, pb)) == _jax_coords(want_add)
    assert _port_coords(C.double(pa)) == _jax_coords(want_double)
    assert C.points_from_device(C.add(pa, pb)) == [B.g1_add(x, y) for x, y in zip(a, b)]


def test_g1_from_jax_carries_points():
    a, _ = _pairs()
    pa = _projective(a, 14)
    with jax.disable_jit():
        jp = JC.double_values(_jax_g1(pa))  # lazily reduced JAX coordinates
    port = convert.g1_from_jax(*(np.asarray(c) for c in jp), "cpu")
    assert _port_coords(port) == _jax_coords(jp)
    assert C.points_from_device(port) == [B.g1_add(x, x) for x in a]

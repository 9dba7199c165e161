"""The port's G2 (rust_eth_kzg_tpu_torch/ops/curve_g2.py) against the JAX
package's ops/curve_g2.py and a host oracle, exactly.

`add` and `double` take JAX's device points through `convert.g2_from_jax`
and must give JAX's points, affine and projective (canonical values), with
identity lanes, a doubling lane and an inverse pair among the inputs.
`g2_lincomb` at N = 6 (an identity point, a zero scalar) is held against
`bls_host` sums of scalar multiplications; JAX's `g2_lincomb` takes about
two minutes to compile on the CPU, so it is not run.
"""

import random

import numpy as np
import pytest
import torch

from rust_eth_kzg_tpu.ops import curve_g2 as JG2
from rust_eth_kzg_tpu_torch.constants import R_SCALAR
from rust_eth_kzg_tpu_torch.ops import curve_g2 as G2
from rust_eth_kzg_tpu_torch.ops import field as F
from rust_eth_kzg_tpu_torch.ops import msm as M
from rust_eth_kzg_tpu_torch.utils import bls_host as B
from rust_eth_kzg_tpu_torch.utils import convert

# One intra-op thread (see tests/test_torch_fk20.py).
torch.set_num_threads(1)

FP, FR = F.FP, F.FR


@pytest.fixture(scope="module")
def pairs():
    rnd = random.Random(41)
    pts1 = [B.g2_mul(B.G2_GEN, rnd.randrange(1, R_SCALAR)) for _ in range(4)]
    pts2 = [B.g2_mul(B.G2_GEN, rnd.randrange(1, R_SCALAR)) for _ in range(4)]
    pts1 += [None, B.G2_GEN, B.G2_GEN, None]  # identity, doubling, inverse, identity + identity
    pts2 += [B.G2_GEN, B.G2_GEN, B.g2_neg(B.G2_GEN), None]
    return pts1, pts2


def _projective_std(p: G2.G2) -> list:
    return [FP.from_mont_host(c.reshape(FP.nlimbs, -1).numpy()) for f in p for c in f]


def _from_jax(p) -> G2.G2:
    return convert.g2_from_jax(tuple(tuple(np.asarray(c) for c in f) for f in p), "cpu")


@pytest.mark.parametrize("op", ["add", "double"])
def test_add_double_match_jax(pairs, op):
    pts1, pts2 = pairs
    ja, jb = JG2.points_to_device(pts1), JG2.points_to_device(pts2)
    a, b = _from_jax(ja), _from_jax(jb)
    assert G2.points_from_device(a) == pts1 and G2.points_from_device(b) == pts2
    if op == "add":
        got, want = G2.add(a, b), _from_jax(JG2.add(ja, jb))
        oracle = [B.g2_add(p, q) for p, q in zip(pts1, pts2)]
    else:
        got, want = G2.double(a), _from_jax(JG2.double(ja))
        oracle = [B.g2_add(p, p) for p in pts1]
    assert G2.points_from_device(got) == G2.points_from_device(want) == oracle
    assert _projective_std(got) == _projective_std(want)


def test_add_of_a_point_to_itself_is_its_double(pairs):
    a = G2.points_to_device(pairs[0], "cpu")
    assert G2.points_from_device(G2.add(a, a)) == G2.points_from_device(G2.double(a))
    assert G2.points_from_device(G2.identity((3,), "cpu")) == [None] * 3


def test_g2_lincomb_matches_host_oracle():
    rnd = random.Random(43)
    n = 6
    pts = [B.g2_mul(B.G2_GEN, rnd.randrange(1, R_SCALAR)) for _ in range(n)]
    pts[2] = None
    scal = [rnd.randrange(R_SCALAR) for _ in range(n)]
    scal[4] = 0
    sm = torch.from_numpy(FR.to_mont_host(scal))
    got = G2.points_from_device(G2.g2_lincomb(G2.points_to_device(pts, "cpu"), sm))
    want = None
    for p, k in zip(pts, scal):
        want = B.g2_add(want, B.g2_mul(p, k))
    assert got == [want]


def test_scalar_bits_msb():
    scal = [0, 1, R_SCALAR - 1, 2**254 + 5]
    bits = M.scalar_bits_msb(torch.from_numpy(FR.to_mont_host(scal)))
    assert bits.shape == (255, 4) and bits.dtype == torch.bool
    got = [int("".join("1" if b else "0" for b in bits[:, j].tolist()), 2) for j in range(4)]
    assert got == scal

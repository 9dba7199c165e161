"""Port NTT and G1 FFT (rust_eth_kzg_tpu_torch.ops.ntt, CPU plain versions).

fft / ifft, and the coset transforms with their scales fused as the `ntt`
kernel takes them, are compared exactly with the JAX package's Domain on
the same inputs. The kernel's schedule (one pass, or the four-step split
with its twiddles and transposed store) is replayed with the plain
formulas and held equal to `Domain._dit_plain`. The G1 transforms are held against a host DFT over points: the JAX
G1-FFT takes minutes to compile on the CPU (its 16-point form is compared
with JAX through the FK20 tables in test_torch_fk20.py). The digit tables
that the plain route and the `g1_fft` kernel both read are held against
`curve.glv_bits_host` of the stage twiddles.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_eth_kzg_tpu.ops import field as JF
from rust_eth_kzg_tpu.ops import ntt as JN
from rust_eth_kzg_tpu_torch.constants import FR_MULTIPLICATIVE_GENERATOR, GLV_NBITS, R_SCALAR
from rust_eth_kzg_tpu_torch.ops import curve as C
from rust_eth_kzg_tpu_torch.ops import field as F
from rust_eth_kzg_tpu_torch.ops import kernels as K
from rust_eth_kzg_tpu_torch.ops import ntt
from rust_eth_kzg_tpu_torch.utils import bls_host as B

# One intra-op thread: the plain versions run many small tensor ops, and
# beside other busy processes (xdist workers, XLA compiles) a thread pool
# stalls each op until all its threads are scheduled.
torch.set_num_threads(1)

FR = F.FR


def _scalars(n, seed):
    rng = np.random.default_rng(seed)
    return [int(v) ** 5 % R_SCALAR for v in rng.integers(1, 2**62, size=n)]


@pytest.mark.parametrize("n", [16, 32, 64, 128])
def test_fft_ifft_match_jax(n):
    b = 2
    vals = _scalars(b * n, n)
    port_in = torch.from_numpy(FR.to_mont_host(vals)).reshape(FR.nlimbs, b, n)
    jax_in = jnp.asarray(JF.FR.to_mont_host(vals)).reshape(JF.FR.nlimbs, b, n)
    dom, jdom = ntt.Domain(n, "cpu"), JN.domain(n)
    assert dom.roots == jdom.roots
    got = dom.fft(port_in)
    want = jdom.fft(jax_in)
    assert FR.from_mont_host(got.reshape(FR.nlimbs, -1).numpy()) == JF.FR.from_mont_host(
        np.asarray(want).reshape(JF.FR.nlimbs, -1)
    )
    back = dom.ifft(got)
    assert FR.from_mont_host(back.reshape(FR.nlimbs, -1).numpy()) == vals
    jback = jdom.ifft(want)
    assert JF.FR.from_mont_host(np.asarray(jback).reshape(JF.FR.nlimbs, -1)) == vals


def _std(t):
    return FR.from_mont_host(t.reshape(FR.nlimbs, -1).numpy())


def _jstd(a):
    return JF.FR.from_mont_host(np.asarray(a).reshape(JF.FR.nlimbs, -1))


@pytest.mark.parametrize("n", [64, 128])
def test_scaled_transforms_match_jax(n):
    """ifft (1/n fused on the output), coset_fft (g^k on the input) and
    coset_ifft ((1/n) g^-k on the output) against JAX's Domain."""
    b, g = 2, FR_MULTIPLICATIVE_GENERATOR
    vals = _scalars(b * n, n + 1)
    port_in = torch.from_numpy(FR.to_mont_host(vals)).reshape(FR.nlimbs, b, n)
    jax_in = jnp.asarray(JF.FR.to_mont_host(vals)).reshape(JF.FR.nlimbs, b, n)
    dom, jdom = ntt.Domain(n, "cpu"), JN.domain(n)
    assert _std(dom.ifft(port_in)) == _jstd(jdom.ifft(jax_in))
    fwd = dom.coset_fft(port_in, g)
    assert _std(fwd) == _jstd(jdom.coset_fft(jax_in, g))
    assert _std(dom.coset_ifft(port_in, g)) == _jstd(jdom.coset_ifft(jax_in, g))
    assert _std(dom.coset_ifft(fwd, g)) == vals


def _line_dft(lines, roots, log_n):
    """The kernel's pass over lines [8, R, m]: bit-reversed load, then the
    stages with twiddle w^(pos n / 2h) read from the n-point table."""
    m = lines.shape[-1]
    tw = roots[:, :: (1 << log_n) // m][:, : max(m // 2, 1)]
    x = ntt.bit_reverse_permutation(lines).contiguous()
    for stage in range(m.bit_length() - 1):
        x = F.butterfly_plain(FR, x, tw, stage)
    return x


def _replay_ntt(dom, x, tag, pre, post, log_n1):
    """The `ntt` kernel's schedule with the plain formulas: the input scale,
    one pass (log_n1 = 0) or the four-step split n = n1 n2 (columns
    x[n2 j1 + j2] of length n1, output k1 of column j2 times w^(j2 k1); then
    the rows of length n2, output k2 of row k1 stored at k1 + n1 k2), the
    output scale."""
    nl, rows, n = x.shape
    roots = dom._roots[tag]
    if pre is not None:
        x = F.mont_mul_plain(FR, x, pre[:, None, :])
    if log_n1 == 0:
        y = _line_dft(x, roots, dom.log_size)
    else:
        n1, n2 = 1 << log_n1, n >> log_n1
        cols = x.reshape(nl, rows, n1, n2).transpose(2, 3).reshape(nl, rows * n2, n1)
        y = _line_dft(cols, roots, dom.log_size).reshape(nl, rows, n2, n1)
        exps = torch.arange(n2)[:, None] * torch.arange(n1)[None, :]
        y = F.mont_mul_plain(FR, y, roots[:, exps][:, None])
        y = y.transpose(2, 3).reshape(nl, rows * n1, n2)
        y = _line_dft(y, roots, dom.log_size).reshape(nl, rows, n1, n2)
        y = y.transpose(2, 3).reshape(nl, rows, n)
    if post is not None:
        y = F.mont_mul_plain(FR, y, post[:, None, :])
    return y


@pytest.mark.parametrize(
    "n,log_n1", [(64, 0), (128, 0), (256, 4), (4096, K.ntt_split(12))], ids=["64", "128", "256_16x16", "4096"]
)
def test_ntt_schedule_replay_matches_dit_plain(n, log_n1):
    """Every transform the kernel serves (fft; ifft; coset_fft; coset_ifft)
    through the replayed schedule equals `_dit_plain` limb for limb."""
    rows, g = 2, FR_MULTIPLICATIVE_GENERATOR
    dom = ntt.Domain(n, "cpu")
    x = torch.from_numpy(FR.to_mont_host(_scalars(rows * n, n + 2))).reshape(FR.nlimbs, rows, n)
    cases = [("fwd", None, None), ("inv", None, dom._scale("ifft")),
             ("fwd", dom._scale(("coset", g)), None), ("inv", None, dom._scale(("coset_inv", g)))]
    for tag, pre, post in cases:
        assert torch.equal(_replay_ntt(dom, x, tag, pre, post, log_n1), dom._dit_plain(x, tag, pre, post))


def test_ntt_plan_and_cpu_refusal():
    """The kernel's split: one pass up to 1,024 points, else n1 = 64 (or n /
    1,024) and n2 at most 1,024; the wrapper refuses CPU tensors."""
    assert [K.ntt_split(k) for k in (0, 6, 7, 10, 11, 12, 13, 20)] == [0, 0, 0, 0, 6, 6, 6, 10]
    for k in range(11, 21):
        assert 6 <= K.ntt_split(k) <= 10 and k - K.ntt_split(k) <= 10
    with pytest.raises(ValueError):
        K.ntt_split(21)
    dom = ntt.Domain(16, "cpu")
    with pytest.raises(ValueError):
        K.ntt(torch.zeros((8, 1, 16), dtype=torch.int32), dom._roots["fwd"])


def test_bit_reverse_matches_jax():
    x = torch.arange(3 * 64).reshape(3, 64)
    got = ntt.bit_reverse_permutation(x).numpy()
    want = np.asarray(JN.bit_reverse_permutation(jnp.asarray(x.numpy())))
    assert np.array_equal(got, want)
    assert np.array_equal(ntt.bitrev_indices(128), JN.bitrev_indices(128))


def _g1_dft(points, root, n_out):
    out = []
    for i in range(n_out):
        acc = None
        for j, p in enumerate(points):
            acc = B.g1_add(acc, B.g1_mul(p, pow(root, i * j, R_SCALAR)) if p else None)
        out.append(acc)
    return out


def _g1_inputs(n, seed):
    rng = np.random.default_rng(seed)
    pts = [B.g1_mul(B.G1_GEN, int(rng.integers(1, 2**62))) for _ in range(n)]
    pts[1] = None
    return pts


@pytest.mark.parametrize("n", [4, 8])
def test_fft_g1_matches_host_dft(n):
    pts = _g1_inputs(n, 1)
    dom = ntt.Domain(n, "cpu")
    p = C._map(lambda c: c.reshape(12, 1, n), C.points_to_device(pts, "cpu"))
    got = C.points_from_device(dom.fft_g1(p))
    assert got == _g1_dft(pts, dom.generator, n)


def test_ifft_g1_take_n_prescaled_matches_host_dft():
    n, take = 8, 4
    pts = _g1_inputs(2 * n, 2)
    dom = ntt.Domain(n, "cpu")
    p = C._map(lambda c: c.reshape(12, 2, n), C.points_to_device(pts, "cpu"))
    got = C.points_from_device(dom.ifft_g1(p, take_n=take, prescaled=True))
    want = _g1_dft(pts[:n], dom.generator_inv, take) + _g1_dft(pts[n:], dom.generator_inv, take)
    assert got == want
    small = ntt.Domain(4, "cpu")
    p4 = C._map(lambda c: c.reshape(12, 1, 4), C.points_to_device(pts[:4], "cpu"))
    scaled = C.points_from_device(small.ifft_g1(p4))
    want = _g1_dft(pts[:4], small.generator_inv, 4)
    assert scaled == [B.g1_mul(q, small.size_inv) if q else None for q in want]


@pytest.mark.parametrize("n", [16, 128])
@pytest.mark.parametrize("tag", ["fwd", "inv"])
def test_stage_digits_match_glv_bits(n, tag):
    dom = ntt.Domain(n, "cpu")
    digits, neg1, neg2 = (t.numpy() for t in dom._stage_digits(tag))
    stages, half = dom.log_size - 1, n // 2
    assert digits.shape == (stages, GLV_NBITS // 2, half) and digits.dtype == np.uint8
    assert neg1.shape == neg2.shape == (stages, half) and neg1.dtype == np.uint8
    gen = dom.generator if tag == "fwd" else dom.generator_inv
    for s in range(1, dom.log_size):
        h = 1 << s
        step = pow(gen, n >> (s + 1), R_SCALAR)
        b1, n1, b2, n2 = C.glv_bits_host([pow(step, pos, R_SCALAR) for pos in range(h)])
        d1 = 2 * b1[0::2].astype(int) + b1[1::2]
        d2 = 2 * b2[0::2].astype(int) + b2[1::2]
        assert np.array_equal(digits[s - 1, :, :h], 4 * d1 + d2)
        assert np.array_equal(neg1[s - 1, :h], n1) and np.array_equal(neg2[s - 1, :h], n2)
        assert not digits[s - 1, :, h:].any() and not neg1[s - 1, h:].any() and not neg2[s - 1, h:].any()


def _dft_of_multiples(ks, root, n_out):
    """The host DFT of the points k_j G, from their scalars: out[i] =
    (sum_j root^(i j) k_j) G, one host multiplication per output."""
    out = []
    for i in range(n_out):
        k = sum(pow(root, i * j, R_SCALAR) * kj for j, kj in enumerate(ks)) % R_SCALAR
        out.append(B.g1_mul(B.G1_GEN, k) if k else None)
    return out


def test_g1_fft_16_matches_host_dft():
    """The plain route at 16 points, both directions, on two rows: random
    points with identity inputs and two equal inputs, and a row that is
    the identity but for two points (the proof transform's padding)."""
    n = 16
    rng = np.random.default_rng(3)
    ks = [int(v) for v in rng.integers(1, 2**62, size=n)]
    ks[6] = ks[9] = 0
    ks[12] = ks[4]
    pad = [ks[0], ks[5]] + [0] * (n - 2)
    pts = [B.g1_mul(B.G1_GEN, k) if k else None for k in ks + pad]
    dom = ntt.Domain(n, "cpu")
    p = C._map(lambda c: c.reshape(12, 2, n), C.points_to_device(pts, "cpu"))
    fwd = C.points_from_device(dom.fft_g1(p))
    assert fwd == _dft_of_multiples(ks, dom.generator, n) + _dft_of_multiples(pad, dom.generator, n)
    inv = C.points_from_device(dom.ifft_g1(p, take_n=8, prescaled=True))
    assert inv == _dft_of_multiples(ks, dom.generator_inv, 8) + _dft_of_multiples(pad, dom.generator_inv, 8)

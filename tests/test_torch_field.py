"""Port field arithmetic (rust_eth_kzg_tpu_torch.ops.field, CPU plain versions)
against the JAX package on the same values, compared exactly in canonical
standard form: the two packages hold different Montgomery residues
(R = 2^(32 L) here, 2^(15 L) in JAX)."""

import ctypes
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_eth_kzg_tpu.ops import field as JF
from rust_eth_kzg_tpu_torch.constants import GLV_BETA
from rust_eth_kzg_tpu_torch.ops import field as F
from rust_eth_kzg_tpu_torch.ops import kernels as K
from rust_eth_kzg_tpu_torch.ops import limbs as L
from rust_eth_kzg_tpu_torch.utils import convert
from rust_eth_kzg_tpu_torch.utils.edge_inputs import edge_operands, inverse_edge_values

# One intra-op thread: the plain versions run many small tensor ops, and
# beside other busy processes (xdist workers, XLA compiles) a thread pool
# stalls each op until all its threads are scheduled.
torch.set_num_threads(1)

PAIRS = [(F.FR, JF.FR), (F.FP, JF.FP)]
IDS = ["fr", "fp"]


def _values(spec, n, seed):
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 2**32, size=(n, spec.nlimbs), dtype=np.uint64)
    vals = [int.from_bytes(row.astype("<u4").tobytes(), "little") % spec.modulus for row in raw]
    vals[:5] = [0, 1, spec.modulus - 1, spec.modulus - 2, spec.modulus // 2]
    return vals


def _port(spec, vals):
    return torch.from_numpy(spec.to_mont_host(vals))


def _jax(jspec, vals):
    return jnp.asarray(jspec.to_mont_host(vals))


def _port_std(spec, t):
    return spec.from_mont_host(t.numpy())


def _jax_std(jspec, a):
    return jspec.from_mont_host(np.asarray(a))


@pytest.mark.parametrize("spec,jspec", PAIRS, ids=IDS)
def test_mont_mul_matches_jax(spec, jspec):
    a, b = _values(spec, 64, 1), _values(spec, 64, 2)
    got = _port_std(spec, F.mont_mul(spec, _port(spec, a), _port(spec, b)))
    want = _jax_std(jspec, JF.mont_mul(jspec, _jax(jspec, a), _jax(jspec, b)))
    assert got == want == [x * y % spec.modulus for x, y in zip(a, b)]


@pytest.mark.parametrize("spec", [F.FR, F.FP], ids=IDS)
def test_mont_mul_at_bounds(spec):
    """a < 2p and b < p are the documented input bounds; the output is < p."""
    m = spec.modulus
    a = [m - 1, 2 * m - 1, m, 0, 1, 2 * m - 2, m + 1, m // 2]
    b = [m - 1, m - 1, m - 1, m - 1, m - 1, 1, m - 2, m - 1]
    out = F.mont_mul(spec, torch.from_numpy(L.ints_to_limbs(a, spec.nlimbs)),
                     torch.from_numpy(L.ints_to_limbs(b, spec.nlimbs)))
    got = L.limbs_to_ints(out.numpy())
    r_inv = pow(spec.r, -1, m)
    assert got == [x * y * r_inv % m for x, y in zip(a, b)]
    assert all(v < m for v in got)


@pytest.mark.parametrize("spec", [F.FR, F.FP], ids=IDS)
def test_mont_mul_plain_edge_operands(spec):
    """mont_mul_plain on the edge operands against Python integers."""
    a, b = edge_operands(spec)
    out = F.mont_mul_plain(spec, torch.from_numpy(L.ints_to_limbs(a, spec.nlimbs)),
                           torch.from_numpy(L.ints_to_limbs(b, spec.nlimbs)))
    r_inv = pow(spec.r, -1, spec.modulus)
    assert L.limbs_to_ints(out.numpy()) == [x * y * r_inv % spec.modulus for x, y in zip(a, b)]


@pytest.mark.parametrize("spec,jspec", PAIRS, ids=IDS)
def test_mont_mul_on_lazy_jax_inputs(spec, jspec):
    """JAX residues lifted up to its documented 24p bound (tests/test_bounds.py)
    and carried over by utils/convert.py: both products agree canonically."""
    m = spec.modulus
    rng = np.random.default_rng(14)
    a, b = _values(spec, 32, 15), _values(spec, 32, 16)

    def lifted(vals):
        """JAX Montgomery limbs of vals, each residue plus k m for a random k < 24."""
        mont = [v * jspec.r_mod_p % m for v in vals]
        out = [r + int(k) * m for r, k in zip(mont, rng.integers(0, 24, size=len(vals)))]
        out[0] = 24 * m - 1  # the top of the bound
        return _jax_limbs(jspec, out)

    ja, jb = lifted(a), lifted(b)
    std_a, std_b = _jax_std(jspec, ja), _jax_std(jspec, jb)
    want = _jax_std(jspec, JF.mont_mul(jspec, jnp.asarray(ja), jnp.asarray(jb)))
    pa, pb = convert.limbs15_to_port(ja, spec, "cpu"), convert.limbs15_to_port(jb, spec, "cpu")
    assert _port_std(spec, pa) == std_a and _port_std(spec, pb) == std_b
    assert _port_std(spec, F.mont_mul(spec, pa, pb)) == want == [x * y % m for x, y in zip(std_a, std_b)]


@pytest.mark.parametrize("spec,jspec", PAIRS, ids=IDS)
def test_to_from_mont_match_jax(spec, jspec):
    vals = _values(spec, 48, 3)
    std = torch.from_numpy(L.ints_to_limbs(vals, spec.nlimbs))
    mont = F.to_mont(spec, std)
    assert L.limbs_to_ints(mont.numpy()) == [v * spec.r % spec.modulus for v in vals]
    assert L.limbs_to_ints(F.from_mont(spec, mont).numpy()) == vals
    jmont = JF.to_mont(jspec, jnp.asarray(_jax_limbs(jspec, vals)))
    assert _jax_std(jspec, jmont) == vals
    assert np.asarray(JF.from_mont(jspec, jmont)).tolist() == _jax_limbs(jspec, vals).tolist()


def _jax_limbs(jspec, vals):
    from rust_eth_kzg_tpu.ops import limbs as JL

    return JL.ints_to_limbs(vals, jspec.nlimbs)


@pytest.mark.parametrize("spec,jspec", PAIRS, ids=IDS)
def test_add_sub_neg_match_jax(spec, jspec):
    a, b = _values(spec, 64, 4), _values(spec, 64, 5)
    pa, pb, ja, jb = _port(spec, a), _port(spec, b), _jax(jspec, a), _jax(jspec, b)
    assert _port_std(spec, F.add(spec, pa, pb)) == _jax_std(jspec, JF.add(jspec, ja, jb))
    assert _port_std(spec, F.sub(spec, pa, pb)) == _jax_std(jspec, JF.sub(jspec, ja, jb, 2))
    assert _port_std(spec, F.neg(spec, pa)) == _jax_std(jspec, JF.neg(jspec, ja, 2))
    assert _port_std(spec, F.double(spec, pa)) == _jax_std(jspec, JF.double(jspec, ja))
    # every port result stays fully reduced
    for out in (F.add(spec, pa, pb), F.sub(spec, pa, pb), F.neg(spec, pa)):
        assert all(v < spec.modulus for v in L.limbs_to_ints(out.numpy()))


@pytest.mark.parametrize("spec", [F.FR, F.FP], ids=IDS)
def test_canonical_select_is_zero(spec):
    m = spec.modulus
    vals = [0, 1, m - 1, m, m + 5, 2 * m - 1]
    t = torch.from_numpy(L.ints_to_limbs(vals, spec.nlimbs))
    assert L.limbs_to_ints(F.canonical(spec, t).numpy()) == [v % m for v in vals]
    assert F.is_zero(spec, F.canonical(spec, t)).tolist() == [True, False, False, True, False, False]
    cond = torch.tensor([True, False, True, False, True, False])
    sel = F.select(cond, t, torch.zeros_like(t))
    assert L.limbs_to_ints(sel.numpy()) == [v if c else 0 for v, c in zip(vals, cond.tolist())]


@pytest.mark.parametrize("spec,jspec", PAIRS, ids=IDS)
def test_pow_fixed_matches_jax(spec, jspec):
    vals = _values(spec, 8, 6)
    e = 0xD201000000010001
    got = _port_std(spec, F.pow_fixed(spec, _port(spec, vals), e))
    want = _jax_std(jspec, JF.pow_fixed(jspec, _jax(jspec, vals), e))
    assert got == want == [pow(v, e, spec.modulus) for v in vals]


@pytest.mark.parametrize("n", [333, 32 * 640], ids=["333", "ragged"])
@pytest.mark.parametrize("spec,jspec", PAIRS, ids=IDS)
def test_batch_inverse_matches_jax(spec, jspec, n):
    vals = _values(spec, n, 7)
    vals[0] = 1  # the edge values of _values include 0, which poisons a block
    got = _port_std(spec, F.batch_inverse(spec, _port(spec, vals)))
    assert got == [pow(v, -1, spec.modulus) for v in vals]
    if n == 333:
        want = _jax_std(jspec, JF.batch_inverse(jspec, _jax(jspec, vals), 1))
        assert got == want


def test_batch_inverse_zero_poisons_its_block():
    spec = F.FP
    vals = _values(spec, 100, 8)
    vals[0], vals[7] = 1, 0  # lane 7 sits in block 7 mod 4 = 3 (blocks of 32, C = 4)
    got = _port_std(spec, F.batch_inverse(spec, _port(spec, vals)))
    for i, (g, v) in enumerate(zip(got, vals)):
        assert g == (0 if i % 4 == 3 else pow(v, -1, spec.modulus))


def _field_cuh():
    with open(os.path.join(K.CSRC, "field.cuh")) as fh:
        return fh.read()


_M31 = (1 << 31) - 1


def _gcd_inverse_model(spec, x, outer):
    """csrc/batch_inverse.cu's gcd_inverse, step for step: 64-bit
    approximations (low 31 bits, 33 bits below the top), 31 binary-GCD steps
    a batch gathered in a matrix with |f| + |g| <= 2^31, the matrix applied
    to a, b (exact division by 2^31) and to u, v (one 32-bit Montgomery
    step), `outer` batches; then the product by R^3 2^outer. x is the
    stored (Montgomery) value; returns the stored value of the inverse, 0
    for x = 0."""
    m = spec.modulus
    a, b, u, v = x, m, 1, 0
    for _ in range(outer):
        n = max(a.bit_length(), b.bit_length(), 64)
        xa, xb = ((w & _M31) | ((w >> (n - 33)) << 31) for w in (a, b))
        assert xa < 1 << 64 and xb < 1 << 64
        f0, g0, f1, g1 = 1, 0, 0, 1
        for _ in range(K.GCD_STEPS):
            if xa & 1:
                if xa < xb:
                    xa, xb, f0, f1, g0, g1 = xb, xa, f1, f0, g1, g0
                xa = (xa - xb) >> 1
                f0, g0 = f0 - f1, g0 - g1
            else:
                xa >>= 1
            f1, g1 = 2 * f1, 2 * g1
        assert abs(f0) + abs(g0) <= 1 << 31 and abs(f1) + abs(g1) <= 1 << 31
        na, nb = f0 * a + g0 * b, f1 * a + g1 * b
        assert na % (1 << 31) == 0 and nb % (1 << 31) == 0
        na, nb = na >> 31, nb >> 31
        if na < 0:
            na, f0, g0 = -na, -f0, -g0
        if nb < 0:
            nb, f1, g1 = -nb, -f1, -g1
        assert na < 1 << (32 * spec.nlimbs) and nb < 1 << (32 * spec.nlimbs)

        def mont(t):
            q = (t & 0xFFFFFFFF) * spec.n0 & 0xFFFFFFFF
            r = (t + q * m) >> 32
            assert -3 * m < 2 * r < 3 * m
            for _ in range(2):
                r += m if r < 0 else 0
            return r - m if r >= m else r

        a, b, u, v = na, nb, mont(f0 * u + g0 * v), mont(f1 * u + g1 * v)
    assert a == 0
    if b != 1:
        return 0
    fix = pow(spec.r, 3, m) * pow(2, outer, m) % m
    return v * fix * pow(spec.r, -1, m) % m


@pytest.mark.parametrize("spec", [F.FP, F.FR], ids=["fp", "fr"])
def test_gcd_inverse_model_matches_pow(spec):
    """The kernel's GCD, modelled at its word sizes, inverts the edge values
    and seeded random values (as Montgomery forms), and maps 0 to 0."""
    outer = K.GCD_OUTER[spec.name]
    m, r = spec.modulus, spec.r_mod_p
    vals = inverse_edge_values(spec) + _values(spec, 200, 11)[5:]
    for a in vals:
        assert _gcd_inverse_model(spec, a * r % m, outer) == pow(a, -1, m) * r % m, a
    assert _gcd_inverse_model(spec, 0, outer) == 0


def test_cuda_constants_match_python():
    """The constants hard-coded in csrc/field.cuh are those of constants.py."""
    src = _field_cuh()

    def arr(name):
        body = re.search(name + r"\[\d+\] = \{([^}]*)\}", src).group(1)
        return sum(int(w, 16) << (32 * i) for i, w in enumerate(re.findall(r"0x[0-9a-f]+", body)))

    fp, fr = F.FP, F.FR
    assert arr("FP_MOD") == fp.modulus and arr("FR_MOD") == fr.modulus
    assert arr("FP_ONE") == fp.r_mod_p and arr("FR_ONE") == fr.r_mod_p
    # the GCD's shape, declared in kernels.py: as field.cuh and batch_inverse.cu have it
    outer = dict(zip(("fp", "fr"), (int(v) for v in re.findall(r"GCD_OUTER = (\d+);", src))))
    with open(os.path.join(K.CSRC, "batch_inverse.cu")) as fh:
        steps = [int(v) for v in re.findall(r"constexpr int STEPS = (\d+);", fh.read())]
    assert outer == K.GCD_OUTER and steps == [K.GCD_STEPS]
    s = K.GCD_STEPS
    assert outer == {"fp": -(-(2 * 381 - 1) // s) + 1, "fr": -(-(2 * 255 - 1) // s) + 1}
    for name, spec in (("FP", fp), ("FR", fr)):
        want = pow(spec.r, 3, spec.modulus) * pow(2, outer[spec.name], spec.modulus) % spec.modulus
        assert arr(f"{name}_INV_FIX") == want
    assert arr("FP_B3") == 12 * fp.r_mod_p % fp.modulus
    assert arr("FP_BETA") == GLV_BETA * fp.r_mod_p % fp.modulus
    n0 = [int(v, 16) for v in re.findall(r"N0 = (0x[0-9a-f]+)u", src)]
    assert n0 == [fp.n0, fr.n0]


def test_limb_codecs():
    vals = _values(F.FR, 40, 9)
    arr = L.ints_to_limbs(vals, 8)
    assert arr.dtype == np.int32 and arr.shape == (8, 40)
    assert L.limbs_to_ints(arr) == vals
    raw = b"".join(v.to_bytes(32, "big") for v in vals)
    assert L.limbs_to_bytes_be(L.bytes_be_to_limbs(raw, 8)) == raw
    assert L.limbs_to_ints(L.bytes_be_to_limbs(raw, 12)) == vals


def test_kernel_wrappers_take_cuda_tensors_only():
    """On the CPU the field ops run the plain versions; a kernel wrapper
    handed a CPU tensor raises instead of falling back."""
    a = _port(F.FR, _values(F.FR, 4, 10))
    with pytest.raises(ValueError):
        K.mont_mul(F.FR, a, a)
    with pytest.raises(ValueError):
        K.batch_inverse(F.FR, a)
    with pytest.raises(ValueError):
        K.g1_double((a, a, a))
    with pytest.raises(ValueError):
        K.mont_mul_chain(F.FR, a, 3)
    x = torch.zeros((12, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        K.g1_decompress(x, torch.zeros(4, dtype=torch.bool), torch.zeros(4, dtype=torch.bool))
    assert sum(K.LAUNCHES.values()) == 0


@pytest.mark.parametrize("name", [*K.KERNELS, *K.PROBES])
def test_kernel_entry_points_match_their_argtypes(name):
    """Each C entry point's parameters, read from its source, are the ctypes
    argtypes its wrapper passes: a pointer for each `void*`, a 64-bit int
    for each `long long`, a 32-bit int for each `int` (ctypes would cut or
    misplace a mismatched argument without an error)."""
    lib, entry = K.PROBES[name] if name in K.PROBES else (name, K.KERNELS[name][1])
    with open(os.path.join(K.CSRC, K.KERNELS[lib][0])) as fh:
        m = re.search(r'extern "C" int ' + entry + r"\(([^)]*)\)", fh.read())
    assert m, f"{entry} not found in {K.KERNELS[lib][0]}"
    params = [p.strip() for p in m.group(1).split(",")]
    kinds = [
        ctypes.c_void_p if "*" in p else ctypes.c_longlong if "long long" in p else ctypes.c_int
        for p in params
    ]
    assert kinds == K._ARGTYPES[entry]

"""The port's cell-proof batch verifier (rust_eth_kzg_tpu_torch, CPU plain
versions) against the JAX package and host oracles.

The JAX verifier's device program (`_verify_device`) compiled for over seven
minutes at the tests/test_fk20.py geometry on an 8-core CPU, past 5.8 GB,
without finishing, so it is held piece by piece: Fiat-Shamir, the byte parser, decompression with its
flags (at tests/test_decompress.py's 7 lanes), the verifier's coset tables
and the error taxonomy against JAX; the native pairing against the Python
pairing; the four points of `verify_device` against a host oracle built
from the known tau of an insecure setup. The variable-base MSMs are held
against JAX in test_torch_msm.py, and JAX-made proofs are verified in
test_torch_fk20.py::test_slice_matches_jax.
"""

import os
import random
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_eth_kzg_tpu import api as JAPI
from rust_eth_kzg_tpu import errors as JE
from rust_eth_kzg_tpu.models.fk20_verifier import FK20Verifier as JFK20Verifier
from rust_eth_kzg_tpu.ops import curve as JC
from rust_eth_kzg_tpu.ops import decompress as JD
from rust_eth_kzg_tpu.ops import limbs as JL
from rust_eth_kzg_tpu.utils import fiat_shamir as JFS
from rust_eth_kzg_tpu_torch import DASContext, TrustedSetup
from rust_eth_kzg_tpu_torch import errors as E
from rust_eth_kzg_tpu_torch.constants import P, R_SCALAR
from rust_eth_kzg_tpu_torch.models import naive
from rust_eth_kzg_tpu_torch.models.fk20 import FK20Config
from rust_eth_kzg_tpu_torch.models.fk20_verifier import verify_device
from rust_eth_kzg_tpu_torch.ops import curve as C
from rust_eth_kzg_tpu_torch.ops import decompress as D
from rust_eth_kzg_tpu_torch.ops import field as F
from rust_eth_kzg_tpu_torch.ops import kernels as K
from rust_eth_kzg_tpu_torch.ops import limbs as LB
from rust_eth_kzg_tpu_torch.ops import ntt
from rust_eth_kzg_tpu_torch.utils import bls_host as B
from rust_eth_kzg_tpu_torch.utils import fiat_shamir as fs
from rust_eth_kzg_tpu_torch.utils import native

# One intra-op thread: the plain versions run many small tensor ops, and
# beside other busy processes (xdist workers, XLA compiles) a thread pool
# stalls each op until all its threads are scheduled.
torch.set_num_threads(1)

CFG = FK20Config(poly_len=64, coset_size=8, expansion=2, fk20_window=4, commit_window=4)
MAINNET_CELL = 2048


def _rand_g1(rnd):
    return B.g1_mul(B.G1_GEN, rnd.randrange(1, R_SCALAR))


def _not_in_subgroup(rnd):
    while True:
        x = rnd.randrange(P)
        y = B.fp_sqrt(x * x * x + 4)
        if y is not None and not B.g1_in_subgroup((x, y)):
            return (x, y)


def _off_curve_bytes(rnd):
    while True:
        x = rnd.randrange(P)
        if B.fp_sqrt(x * x * x + 4) is None:
            data = bytearray(x.to_bytes(48, "big"))
            data[0] |= 0x80
            return bytes(data)


# --- host pieces ---


def test_fiat_shamir_matches_jax():
    rnd = random.Random(1)
    comms = [B.g1_compress(_rand_g1(rnd)) for _ in range(2)]
    cells = [rnd.randbytes(256) for _ in range(5)]
    proofs = [B.g1_compress(_rand_g1(rnd)) for _ in range(5)]
    args = (64, 8, comms, [0, 1, 1, 0, 1], [3, 0, 15, 7, 7], cells, proofs)
    r = fs.compute_cell_batch_challenge(*args)
    assert r == JFS.compute_cell_batch_challenge(*args)
    assert fs.compute_powers(r, 9) == JFS.compute_powers(r, 9)


def test_parse_compressed_matches_jax():
    rnd = random.Random(2)
    raw = [B.g1_compress(_rand_g1(rnd)) for _ in range(5)] + [B.g1_compress(None), _off_curve_bytes(rnd)]
    x, sort, inf = D.parse_compressed_g1_batch(raw)
    jx, jsort, jinf = JD.parse_compressed_g1_batch(raw)
    assert LB.limbs_to_ints(x) == JL.limbs_to_ints(jx)
    assert sort.tolist() == jsort.tolist() and inf.tolist() == jinf.tolist()
    good = raw[0]
    big = (0x80 << 376) | P
    for bad in (
        [good[:40]],
        [good, bytes([good[0] & 0x7F]) + good[1:]],
        [bytes([0xC0]) + bytes(46) + b"\x01"],
        [bytes([0xE0]) + bytes(47)],
        [good, big.to_bytes(48, "big")],
    ):
        with pytest.raises(E.SerializationError) as got:
            D.parse_compressed_g1_batch(bad)
        with pytest.raises(JE.SerializationError) as want:
            JD.parse_compressed_g1_batch(bad)
        assert str(got.value) == str(want.value)


def test_decompress_matches_jax():
    """7 lanes (tests/test_decompress.py's size): four random points, the
    identity, an x off the curve and a curve point outside the subgroup.
    Points and on-curve flags must agree; the subgroup flag where the lane is
    on the curve (off it, the two ladders add different garbage)."""
    import torch

    rnd = random.Random(3)
    pts = [_rand_g1(rnd) for _ in range(4)] + [None]
    raw = [B.g1_compress(p) for p in pts] + [_off_curve_bytes(rnd), B.g1_compress(_not_in_subgroup(rnd))]
    x, sort, inf = D.parse_compressed_g1_batch(raw)
    before = dict(K.LAUNCHES)
    got, on_curve, in_sub = D.decompress_g1(torch.from_numpy(x), torch.from_numpy(sort), torch.from_numpy(inf))
    assert K.LAUNCHES == before  # CPU tensors: the plain route, no kernel
    plain = D.decompress_g1_plain(torch.from_numpy(x), torch.from_numpy(sort), torch.from_numpy(inf))
    assert all(torch.equal(g, w) for g, w in zip((*got, on_curve, in_sub), (*plain[0], *plain[1:])))
    jx, jsort, jinf = JD.parse_compressed_g1_batch(raw)
    want, jon, jsub = JD.decompress_g1(jnp.asarray(jx), jnp.asarray(jsort), jnp.asarray(jinf))
    on_curve, jon = on_curve.tolist(), np.asarray(jon).tolist()
    assert on_curve == jon == [True] * 5 + [False, True]
    live = [i for i, ok in enumerate(on_curve) if ok]
    assert [in_sub.tolist()[i] for i in live] == [np.asarray(jsub).tolist()[i] for i in live] == [True] * 5 + [False]
    port_pts = C.points_from_device(C._map(lambda c: c[:, live], got))
    jax_pts = JC.points_from_device(JC.G1(*(c[:, live] for c in want)))
    assert port_pts == jax_pts and port_pts[:5] == pts


def test_g1_decompress_kernel_constants():
    """The constants of csrc/g1_decompress.cu: R^2, b R and (p - 1)/2 + 1,
    the sliding-window schedule of the square root's exponent (p + 1)/4, and
    the subgroup ladder's scalar z^2 - 1."""
    path = os.path.join(os.path.dirname(D.__file__), "..", "csrc", "g1_decompress.cu")
    with open(path) as fh:
        src = fh.read()

    def arr(name):
        body = re.search(name + r"\[[^\]]*\] = \{([^}]*)\}", src).group(1)
        return [int(w, 0) for w in re.findall(r"0x[0-9a-f]+|\d+", body)]

    def fp(name):
        return sum(w << (32 * i) for i, w in enumerate(arr(name)))

    r = F.FP.r
    assert fp("FP_R2") == r * r % P and fp("FP_B") == 4 * r % P
    assert fp("FP_HALF_PLUS_1") == (P - 1) // 2 + 1
    steps = arr("SQRT_STEPS")
    assert len(steps) == 2 * int(re.search(r"SQRT_NSTEPS = (\d+);", src).group(1))
    e = 0
    for squarings, digit in zip(steps[0::2], steps[1::2]):
        assert digit == 0 or (digit % 2 == 1 and digit < 32)
        e = (e << squarings) + digit
    assert e == (P + 1) // 4 and steps[0] == 0
    hi, lo = (int(re.search(name + r" = (0x[0-9a-f]+)ull;", src).group(1), 16) for name in ("SUBGROUP_HI", "SUBGROUP_LO"))
    assert (hi << 64) | lo == D.SUBGROUP_SCALAR and D.SUBGROUP_SCALAR.bit_length() == 128


def test_raise_for_flags_matches_jax():
    labels = ["commitment 0", "proof 0", "proof 1"]
    cases = [
        ([True, True, True], [True, True, True], None),
        ([True, True, False], [True, False, True], "proof 1: x coordinate not on curve"),
        ([True, True, True], [True, True, False], "proof 1: point not in the prime-order subgroup"),
    ]
    for on_curve, in_sub, message in cases:
        outcomes = []
        for fn, exc in ((D.raise_for_flags, E.SerializationError), (JD.raise_for_flags, JE.SerializationError)):
            try:
                fn(np.array(on_curve), np.array(in_sub), labels)
                outcomes.append(None)
            except exc as err:
                outcomes.append(str(err))
        assert outcomes == [message, message]


def test_native_pairing_matches_python():
    rnd = random.Random(4)
    p = _rand_g1(rnd)
    q = B.g2_mul(B.G2_GEN, rnd.randrange(1, R_SCALAR))
    a = rnd.randrange(1, R_SCALAR)
    good = [(B.g1_mul(p, a), q), (B.g1_neg(p), B.g2_mul(q, a))]
    bad = [(B.g1_mul(p, a + 1), q), good[1]]
    assert native.multi_pairings(good) is True and B.multi_pairings(good) is True
    assert native.multi_pairings(bad) is False and B.multi_pairings(bad) is False
    assert native.multi_pairings([(None, B.G2_GEN), (B.G1_GEN, None)]) is True
    assert native.selftest(p, q)


# --- the verifier at the small geometry ---


@pytest.fixture(scope="module")
def setup():
    g1s, g2s, tau = naive.insecure_setup(CFG.poly_len, CFG.coset_size + 1)
    return g1s, g2s, tau


@pytest.fixture(scope="module")
def ctx(setup):
    return DASContext(device="cpu", trusted_setup=TrustedSetup(*setup[:2]), config=CFG)


def _blob_data(coeffs, tau):
    """Cells, proofs and the commitment of the polynomial `coeffs`, from the
    host oracle (models/naive.py)."""
    ext = ntt.Domain(CFG.ext_size, "cpu")
    coset = ntt.Domain(CFG.coset_size, "cpu")
    evals = naive.ntt_host(coeffs + [0] * (CFG.ext_size - CFG.poly_len), ext.generator)
    flat = [evals[int(i)] for i in ntt.bitrev_indices(CFG.ext_size)]
    m = CFG.coset_size
    cells = [b"".join(v.to_bytes(32, "big") for v in flat[k * m : (k + 1) * m]) for k in range(CFG.num_proofs)]
    rev = ntt.bitrev_indices(CFG.num_proofs)
    proofs = []
    for k in range(CFG.num_proofs):
        hk = ext.roots[int(rev[k])]
        proof, _ = naive.compute_multi_opening_naive(coeffs, [hk * w % R_SCALAR for w in coset.roots], tau)
        proofs.append(B.g1_compress(proof))
    return cells, proofs, B.g1_compress(naive.commit_with_tau(coeffs, tau)), [ext.roots[int(r)] for r in rev]


@pytest.fixture(scope="module")
def blobs(setup):
    rng = np.random.default_rng(5)
    tau = setup[2]
    a = [int(v) ** 3 % R_SCALAR for v in rng.integers(1, 2**62, size=CFG.poly_len)]
    b = [int(v) ** 3 % R_SCALAR for v in rng.integers(1, 2**62, size=CFG.poly_len)]
    return {"a": (a, *_blob_data(a, tau)), "b": (b, *_blob_data(b, tau))}


def test_verifier_tables_match_jax(setup, ctx):
    g1s, g2s, _ = setup
    mine = ctx.verifier
    theirs = JFK20Verifier(g1s[: len(g2s)], g2s, CFG.coset_size, CFG.poly_len, CFG.ext_size, CFG.num_proofs)
    assert mine.coset_gens == theirs.coset_gens
    assert mine.coset_gens_pow_n == theirs.coset_gens_pow_n
    got = F.FR.from_mont_host(mine.coset_scale.reshape(F.FR.nlimbs, -1).numpy())
    want = JC.F.FR.from_mont_host(np.asarray(theirs._coset_scale).reshape(theirs._coset_scale.shape[0], -1))
    assert got == want
    assert mine.tau_pow_n_g2 == theirs.tau_pow_n_g2
    assert [mine.padded_size(n) for n in (1, 16, 17, 100)] == [16, 16, 32, 128]


def _interp_mod(coeffs, hn):
    """p mod (X^n - hn): the polynomial that interpolates p over a coset."""
    n = CFG.coset_size
    out = [0] * n
    for i, c in enumerate(coeffs):
        out[i % n] = (out[i % n] + c * pow(hn, i // n, R_SCALAR)) % R_SCALAR
    return out


def test_verify_device_matches_host_oracle(setup, ctx, blobs):
    """The four points of verify_device on 12 cells of blob a (a subset, in
    scrambled order) against sums over host points; then the closing check
    accepts."""
    g1s, _, tau = setup
    coeffs, cells, proofs, comm, hs = blobs["a"]
    order = [3, 0, 15, 7, 8, 11, 1, 2, 12, 9, 5, 14]
    args = ctx.verify_inputs([comm] * len(order), order, [cells[k] for k in order], [proofs[k] for k in order])
    r = args[-1]
    inputs = ctx.verifier.prepare(*args)
    aff, on_curve, in_sub = verify_device(ctx.verifier, *inputs.tensors)
    assert bool(on_curve.all()) and bool(in_sub.all())
    rp = fs.compute_powers(r, len(order))
    pts = [B.g1_decompress(proofs[k]) for k in order]
    n = CFG.coset_size

    def msm(points, scalars):
        acc = None
        for p, k in zip(points, scalars):
            acc = B.g1_add(acc, B.g1_mul(p, k))
        return acc

    interp = [0] * n
    for ri, k in zip(rp, order):
        for j, c in enumerate(_interp_mod(coeffs, pow(hs[k], n, R_SCALAR))):
            interp[j] = (interp[j] + ri * c) % R_SCALAR
    want = [
        msm(pts, rp),
        msm(pts, [ri * pow(hs[k], n, R_SCALAR) % R_SCALAR for ri, k in zip(rp, order)]),
        B.g1_mul(B.g1_decompress(comm), sum(rp) % R_SCALAR),
        msm(g1s[:n], interp),
    ]
    assert C.affine_from_device(aff) == want
    ctx.verifier.check(inputs, (aff, on_curve, in_sub))


def test_verify_accepts_duplicate_and_identity_commitments(ctx, blobs):
    """Cells of blob a and of blob b interleaved under repeated commitments,
    and the cells of the zero blob under the identity commitment."""
    _, ca, pa, comm_a, _ = blobs["a"]
    _, cb, pb, comm_b, _ = blobs["b"]
    zero_cell = bytes(32 * CFG.coset_size)
    ident = B.g1_compress(None)
    entries = [(comm_a, 2, ca, pa), (comm_b, 5, cb, pb), (ident, 4, None, None), (comm_a, 9, ca, pa),
               (comm_b, 0, cb, pb), (ident, 13, None, None), (comm_a, 2, ca, pa)]
    comms = [e[0] for e in entries]
    idx = [e[1] for e in entries]
    cells = [zero_cell if e[2] is None else e[2][e[1]] for e in entries]
    proofs = [ident if e[3] is None else e[3][e[1]] for e in entries]
    assert ctx.verify_cell_kzg_proof_batch(comms, idx, cells, proofs) is None
    assert ctx.verify_cell_kzg_proof_batch([], [], [], []) is None


def test_verify_rejects_a_changed_cell(ctx, blobs):
    _, cells, proofs, comm, _ = blobs["a"]
    changed = list(cells)
    v = (int.from_bytes(changed[6][:32], "big") + 1) % R_SCALAR
    changed[6] = v.to_bytes(32, "big") + changed[6][32:]
    with pytest.raises(E.InvalidProofError):
        ctx.verify_cell_kzg_proof_batch([comm] * 16, list(range(16)), changed, proofs)


def test_verify_reports_off_curve_before_subgroup(ctx, blobs):
    """Proof 2 outside the subgroup, proof 9 off the curve: the off-curve
    point is reported, as the reference checks the curve first."""
    _, cells, proofs, comm, _ = blobs["a"]
    rnd = random.Random(6)
    bad = list(proofs)
    bad[2] = B.g1_compress(_not_in_subgroup(rnd))
    bad[9] = _off_curve_bytes(rnd)
    with pytest.raises(E.SerializationError, match="proof 9: x coordinate not on curve"):
        ctx.verify_cell_kzg_proof_batch([comm] * 16, list(range(16)), cells, bad)


def test_verify_validation_matches_jax(ctx, blobs):
    """Length and index checks raise VerifierError and malformed bytes
    SerializationError, before any device work; at mainnet geometry against
    the JAX API (host only: its checks run before it reads its context)."""
    _, cells, proofs, comm, _ = blobs["a"]
    cases = [
        ([comm] * 3, [0, 1], cells[:3], proofs[:3]),  # length mismatch
        ([comm] * 2, [0, 16], cells[:2], proofs[:2]),  # index out of range (max 16)
        ([comm] * 2, [0, 1], [cells[0], cells[1][:-1]], proofs[:2]),  # cell length
        ([comm] * 2, [0, 1], [cells[0], R_SCALAR.to_bytes(32, "big") + cells[1][32:]], proofs[:2]),
        ([comm] * 2, [0, 1], cells[:2], [proofs[0], proofs[1][:47]]),  # proof length
    ]
    want = [E.VerifierError, E.VerifierError, E.SerializationError, E.SerializationError, E.SerializationError]
    for args, cls in zip(cases, want):
        with pytest.raises(cls):
            ctx.verify_cell_kzg_proof_batch(*args)
    mainnet = type("Ctx", (), {"config": FK20Config()})()
    for comms, idx, ncells in (([comm] * 3, [0, 1], 3), ([comm] * 2, [0, 128], 2)):
        mcells = [bytes(MAINNET_CELL)] * ncells
        with pytest.raises(E.VerifierError) as got:
            DASContext.verify_inputs(_with_verifier(mainnet), comms, idx, mcells, proofs[: len(comms)])
        with pytest.raises(JE.VerifierError) as theirs:
            JAPI.DASContext.verify_cell_kzg_proof_batch(mainnet, comms, idx, mcells, proofs[: len(comms)])
        assert str(got.value) == str(theirs.value)


def _with_verifier(obj):
    obj.verifier = object()  # the checks under test run before the verifier is used
    return obj

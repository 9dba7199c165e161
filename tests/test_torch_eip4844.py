"""The port's EIP-4844 calls (rust_eth_kzg_tpu_torch, CPU plain versions)
against the JAX package and host oracles.

At the tests/test_fk20.py geometry (poly_len 64, cells of 8, windows 4, an
insecure setup whose tau is known) one module-scoped context serves every
test. Held against JAX: `poly_eval` and `divide_by_linear` (exact in
standard form, each package with its own Montgomery form of the same
ints), the two Fiat-Shamir challenges byte for byte, the G1 codec's error
classes and texts, and the proofs: y and the proof equal JAX's quotient
committed as [q(tau)]_1 with JAX's host arithmetic, and JAX's host verifier
accepts them. JAX's Context4844 reads only mainnet blobs and its batch
verifier's MSM compiles for minutes on the CPU, so the batch verifier is
held by its verdicts and by its two MSM points against a host oracle.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_eth_kzg_tpu import errors as JE
from rust_eth_kzg_tpu.models.kzg_single import SingleOpenVerifier as JSingleOpenVerifier
from rust_eth_kzg_tpu.ops import field as JF
from rust_eth_kzg_tpu.ops import poly as JP
from rust_eth_kzg_tpu.utils import bls_host as JB
from rust_eth_kzg_tpu.utils import fiat_shamir as JFS
from rust_eth_kzg_tpu.utils import native as JN
from rust_eth_kzg_tpu.utils import serialization as JSER
from rust_eth_kzg_tpu_torch import Context4844, DASContext, TrustedSetup
from rust_eth_kzg_tpu_torch import errors as E
from rust_eth_kzg_tpu_torch.constants import P, R_SCALAR
from rust_eth_kzg_tpu_torch.models import naive
from rust_eth_kzg_tpu_torch.models.fk20 import FK20Config
from rust_eth_kzg_tpu_torch.ops import curve as C
from rust_eth_kzg_tpu_torch.ops import field as F
from rust_eth_kzg_tpu_torch.ops import kernels as K
from rust_eth_kzg_tpu_torch.ops import msm as M
from rust_eth_kzg_tpu_torch.ops import ntt
from rust_eth_kzg_tpu_torch.ops import poly as POLY
from rust_eth_kzg_tpu_torch.utils import bls_host as B
from rust_eth_kzg_tpu_torch.utils import fiat_shamir as fs
from rust_eth_kzg_tpu_torch.utils import serialization as ser
from rust_eth_kzg_tpu_torch.utils.edge_inputs import not_in_subgroup_bytes, off_curve_bytes

# One intra-op thread: the plain versions run many small tensor ops, and
# beside other busy processes (xdist workers, XLA compiles) a thread pool
# stalls each op until all its threads are scheduled.
torch.set_num_threads(1)

CFG = FK20Config(poly_len=64, coset_size=8, expansion=2, fk20_window=4, commit_window=4)
N = CFG.poly_len
FR = F.FR


def _scalar(v: int) -> bytes:
    return v.to_bytes(32, "big")


def _blob_of(coeffs):
    """The blob (bit-reversed evaluations) of a coefficient vector."""
    dom = ntt.Domain(N, "cpu")
    evals = naive.ntt_host(coeffs, dom.generator)
    return b"".join(_scalar(evals[int(r)]) for r in ntt.bitrev_indices(N))


@pytest.fixture(scope="module")
def setup():
    g1s, g2s, tau = naive.insecure_setup(N, CFG.coset_size + 1)
    rnd = random.Random(44)
    coeffs = [[rnd.randrange(R_SCALAR) for _ in range(N)] for _ in range(2)]
    return g1s, g2s, tau, coeffs, [_blob_of(c) for c in coeffs]


@pytest.fixture(scope="module")
def ctx(setup):
    return DASContext(device="cpu", trusted_setup=TrustedSetup(setup[0], setup[1]), config=CFG)


@pytest.fixture(scope="module")
def commitments(setup, ctx):
    return [ctx.blob_to_kzg_commitment(b) for b in setup[4]]


@pytest.fixture(scope="module")
def blob_proofs(setup, ctx, commitments):
    return [ctx.compute_blob_kzg_proof(b, c) for b, c in zip(setup[4], commitments)]


@pytest.fixture(scope="module")
def opening(setup, ctx):
    """(z, compute_kzg_proof of blob 0 at z) at a seeded z."""
    z = random.Random(16).randrange(R_SCALAR)
    return z, ctx.compute_kzg_proof(setup[4][0], _scalar(z))


# --- polynomial arithmetic and Fiat-Shamir ---


def _z_values(kind, rnd):
    root = ntt.Domain(N, "cpu").generator
    return {
        "zero": [0, 0, 0],
        "one": [1, 1, 1],
        "domain_root": [pow(root, k, R_SCALAR) for k in (0, 5, N - 1)],
        "r_minus_1": [R_SCALAR - 1] * 3,
        "seeded": [rnd.randrange(R_SCALAR) for _ in range(3)],
    }[kind]


@pytest.mark.parametrize("kind", ["zero", "one", "domain_root", "r_minus_1", "seeded"])
def test_poly_eval_and_divide_match_jax(kind):
    """[8, 3, 64] coefficients and three z per kind; exact in standard form."""
    rnd = random.Random(7)
    coeffs = [rnd.randrange(R_SCALAR) for _ in range(3 * N)]
    coeffs[:N] = [R_SCALAR - 1] * N  # a row of maximal coefficients
    zs = _z_values(kind, rnd)
    port_c = torch.from_numpy(FR.to_mont_host(coeffs)).reshape(FR.nlimbs, 3, N)
    port_z = torch.from_numpy(FR.to_mont_host(zs))
    jax_c = jnp.asarray(JF.FR.to_mont_host(coeffs).reshape(JF.FR.nlimbs, 3, N))
    jax_z = jnp.asarray(JF.FR.to_mont_host(zs))

    y = FR.from_mont_host(POLY.poly_eval(port_c, port_z).numpy())
    q, rem = POLY.divide_by_linear(port_c, port_z)
    jy = JF.FR.from_mont_host(np.asarray(JP.poly_eval(jax_c, jax_z)))
    jq, jrem = JP.divide_by_linear(jax_c, jax_z)
    assert q.shape == (FR.nlimbs, 3, N - 1)
    assert y == jy == [naive.poly_eval_host(coeffs[i * N : (i + 1) * N], z) for i, z in enumerate(zs)]
    assert FR.from_mont_host(rem.numpy()) == JF.FR.from_mont_host(np.asarray(jrem)) == y
    assert FR.from_mont_host(q.reshape(FR.nlimbs, -1).numpy()) == JF.FR.from_mont_host(
        np.asarray(jq).reshape(JF.FR.nlimbs, -1)
    )


def test_poly_pads_to_a_power_of_two():
    rnd = random.Random(8)
    for n in (1, 2, 5, 33):
        coeffs = [rnd.randrange(R_SCALAR) for _ in range(n)]
        z = rnd.randrange(R_SCALAR)
        c = torch.from_numpy(FR.to_mont_host(coeffs)).reshape(FR.nlimbs, 1, n)
        zt = torch.from_numpy(FR.to_mont_host([z]))
        assert FR.from_mont_host(POLY.poly_eval(c, zt).numpy()) == [naive.poly_eval_host(coeffs, z)]
        q, rem = POLY.divide_by_linear(c, zt)
        qs = FR.from_mont_host(q.reshape(FR.nlimbs, -1).numpy()) if n > 1 else []
        # f = q (X - z) + f(z), coefficient by coefficient
        prod = [0] * n
        for i, qi in enumerate(qs):
            prod[i] = (prod[i] - z * qi) % R_SCALAR
            prod[i + 1] = (prod[i + 1] + qi) % R_SCALAR
        prod[0] = (prod[0] + FR.from_mont_host(rem.numpy())[0]) % R_SCALAR
        assert prod == coeffs


def test_fiat_shamir_matches_jax(setup, commitments):
    rnd = random.Random(9)
    mainnet_blob = rnd.randbytes(131072)
    for blob, c in ((setup[4][0], commitments[0]), (mainnet_blob, commitments[1])):
        assert fs.compute_blob_challenge(blob, c) == JFS.compute_blob_challenge(blob, c)
    zs = [rnd.randrange(R_SCALAR) for _ in range(3)]
    ys = [rnd.randrange(R_SCALAR) for _ in range(3)]
    proofs = [B.g1_compress(B.g1_mul(B.G1_GEN, k)) for k in (3, 4, 5)]
    args = (N, commitments + [commitments[0]], zs, ys, proofs, 3)
    assert fs.compute_r_powers_blob_batch(*args) == JFS.compute_r_powers_blob_batch(*args)


# --- the G1 codec ---


def _good_points(n, seed):
    rnd = random.Random(seed)
    return [B.g1_compress(B.g1_mul(B.G1_GEN, rnd.randrange(1, R_SCALAR))) for _ in range(n)]


BAD_POINTS = {
    "bad_length": lambda rnd: _good_points(1, 1)[0][:47],
    "uncompressed": lambda rnd: bytes([_good_points(1, 1)[0][0] & 0x7F]) + _good_points(1, 1)[0][1:],
    "bad_infinity": lambda rnd: bytes([0xC0]) + bytes(46) + b"\x01",
    "non_canonical": lambda rnd: ((0x80 << 376) | P).to_bytes(48, "big"),
    "off_curve": off_curve_bytes,
    "not_in_subgroup": not_in_subgroup_bytes,
}


def _outcome(fn, *args):
    try:
        fn(*args)
    except (E.SerializationError, JE.SerializationError) as exc:
        return type(exc).__name__, str(exc)
    return None


@pytest.mark.parametrize("kind", list(BAD_POINTS))
def test_deserialize_g1_errors_match_jax(kind):
    """Each error class, alone and as the third point of a batch: the port's
    class and, where JAX's native library is built, its text."""
    bad = BAD_POINTS[kind](random.Random(10))
    batch = _good_points(2, 11) + [bad]
    got = [_outcome(ser.deserialize_g1, bad, "cpu"), _outcome(ser.deserialize_g1_batch, batch, "cpu")]
    want = [_outcome(JSER.deserialize_g1, bad), _outcome(JSER.deserialize_g1_batch, batch)]
    assert [g[0] for g in got] == [w[0] for w in want] == ["SerializationError"] * 2
    assert got[1][1].startswith("G1 point 2 " if kind == "bad_length" else "point 2: ")
    if JN.available():
        assert got == want


def test_deserialize_g1_batch_names_the_first_bad_point():
    """The first failing point in input order, whatever its class, and the
    lengths of the whole batch before any point's value."""
    rnd = random.Random(12)
    good = _good_points(2, 13)
    cases = [
        [good[0], off_curve_bytes(rnd), BAD_POINTS["uncompressed"](rnd)],
        [not_in_subgroup_bytes(rnd), good[1], BAD_POINTS["non_canonical"](rnd)],
        [off_curve_bytes(rnd), good[0][:40]],
    ]
    for batch in cases:
        got = _outcome(ser.deserialize_g1_batch, batch, "cpu")
        assert got[0] == "SerializationError"
        if JN.available():
            assert got == _outcome(JSER.deserialize_g1_batch, batch)
    assert _outcome(ser.deserialize_g1_batch, cases[0], "cpu")[1].startswith("point 1: ")
    assert _outcome(ser.deserialize_g1_batch, cases[2], "cpu")[1].startswith("G1 point 1 ")


def test_g1_codec_round_trip_matches_jax():
    rnd = random.Random(14)
    pts = [B.g1_mul(B.G1_GEN, rnd.randrange(1, R_SCALAR)) for _ in range(3)] + [None, B.G1_GEN]
    raw = [ser.serialize_g1(p) for p in pts]
    assert raw == [JSER.serialize_g1(p) for p in pts]
    before = dict(K.LAUNCHES)
    assert ser.deserialize_g1_batch(raw, "cpu") == JSER.deserialize_g1_batch(raw) == pts
    assert ser.deserialize_g1(raw[0], "cpu") == pts[0]
    assert K.LAUNCHES == before  # CPU tensors: the plain route, no kernel


# --- lincomb_host ---


def test_lincomb_host_matches_host_sum():
    """[3, 3] lanes: an identity point, a zero scalar, r - 1 and a scalar
    above r among them, and a row of zero scalars, against the host sums."""
    rnd = random.Random(15)
    pts = [B.g1_mul(B.G1_GEN, rnd.randrange(1, R_SCALAR)) for _ in range(6)]
    pts[2] = None
    pts += pts[:3]
    rows = [[rnd.randrange(R_SCALAR), 0, R_SCALAR - 1], [rnd.randrange(R_SCALAR), 7, R_SCALAR + 5], [0, 0, 0]]
    dev = C._map(lambda c: c.reshape(12, 3, 3), C.points_to_device(pts, "cpu"))
    want = []
    for r, row in enumerate(rows):
        acc = None
        for p, k in zip(pts[3 * r : 3 * r + 3], row):
            acc = B.g1_add(acc, B.g1_mul(p, k) if p is not None else None)
        want.append(acc)
    assert want[2] is None
    before = dict(K.LAUNCHES)
    assert C.points_from_device(M.lincomb_host(dev, rows)) == want
    assert K.LAUNCHES == before  # CPU tensors: the plain route, no kernel


# --- the five calls ---


def _jax_proof(coeffs, z, tau):
    """JAX's quotient of f by (X - z), committed as [q(tau)]_1 with JAX's
    host arithmetic; and y = f(z). f is the first of three rows, the shape
    test_poly_eval_and_divide_match_jax has JAX compile."""
    rows = coeffs + [0] * (2 * N)
    c = jnp.asarray(JF.FR.to_mont_host(rows).reshape(JF.FR.nlimbs, 3, N))
    q, y = JP.divide_by_linear(c, jnp.asarray(JF.FR.to_mont_host([z, 0, 0])))
    qs = JF.FR.from_mont_host(np.asarray(q)[:, 0])
    q_tau = sum(qi * pow(tau, i, R_SCALAR) for i, qi in enumerate(qs)) % R_SCALAR
    return JB.g1_compress(JB.g1_mul(JB.G1_GEN, q_tau)), JF.FR.from_mont_host(np.asarray(y))[0]


def test_compute_kzg_proof_matches_jax(setup, ctx, commitments, opening):
    """At a seeded z and at a domain root (where y is a blob element): y and
    the proof equal JAX's; JAX's host verifier accepts them and rejects
    y + 1, and so does the port's."""
    g1s, g2s, tau, coeffs, blobs = setup
    jver = JSingleOpenVerifier(gen_g1=g1s[0], gen_g2=g2s[0], tau_g2=g2s[1])
    root = ntt.Domain(N, "cpu").generator
    c0 = JB.g1_decompress(commitments[0])
    for z in (opening[0], pow(root, 3, R_SCALAR)):
        proof, y = opening[1] if z == opening[0] else ctx.compute_kzg_proof(blobs[0], _scalar(z))
        want_proof, want_y = _jax_proof(coeffs[0], z, tau)
        assert (proof, int.from_bytes(y, "big")) == (want_proof, want_y)
        assert want_y == naive.poly_eval_host(coeffs[0], z)
        jver.verify_kzg_proof(c0, z, want_y, JB.g1_decompress(proof))
    with pytest.raises(JE.InvalidProofError):
        jver.verify_kzg_proof(c0, z, (want_y + 1) % R_SCALAR, JB.g1_decompress(proof))
    # z = w^3: y is the blob's element at natural index 3
    idx = int(np.flatnonzero(ntt.bitrev_indices(N) == 3)[0])
    assert y == blobs[0][32 * idx : 32 * idx + 32]
    ctx.verify_kzg_proof(commitments[0], _scalar(z), y, proof)
    with pytest.raises(E.InvalidProofError):
        ctx.verify_kzg_proof(commitments[0], _scalar(z), _scalar(int.from_bytes(y, "big") + 1), proof)


def test_blob_proofs_verify(setup, ctx, commitments, blob_proofs):
    """compute_blob_kzg_proof at the Fiat-Shamir challenge equals the JAX
    quotient's commitment there; the single and batch checks accept, the
    zero blob gives the identity; a swapped pair is rejected; the empty
    batch passes."""
    g1s, g2s, tau, coeffs, blobs = setup
    proofs = blob_proofs
    z0 = JFS.compute_blob_challenge(blobs[0], commitments[0])
    assert proofs[0] == _jax_proof(coeffs[0], z0, tau)[0]
    ctx.verify_blob_kzg_proof(blobs[0], commitments[0], proofs[0])
    zero, cz = bytes(32 * N), B.g1_compress(None)  # the zero blob commits to the identity
    pz = ctx.compute_blob_kzg_proof(zero, cz)
    assert pz == cz
    ctx.verify_blob_kzg_proof_batch(blobs + [zero], commitments + [cz], proofs + [pz])
    ctx.verify_blob_kzg_proof_batch([], [], [])
    with pytest.raises(E.InvalidProofError):
        ctx.verify_blob_kzg_proof_batch(blobs, commitments, proofs[::-1])


def test_batch_verifier_points_match_host_oracle(setup, ctx, commitments, blob_proofs):
    """The batch check's two MSM points (one lincomb_host call over [2, 2B+1]
    lanes, an identity commitment and proof among them) against host sums."""
    g1s, _, tau, _, blobs = setup
    eip = ctx.eip4844
    comms = commitments + [B.g1_compress(None)]
    blobs = blobs + [bytes(32 * N)]
    proofs = blob_proofs + [B.g1_compress(None)]
    cs, pfs = ser.decompress_g1_groups([comms, proofs], "cpu")
    zs = eip.challenges(blobs, comms)
    ys = eip.evaluate(blobs, zs)
    r_powers = fs.compute_r_powers_blob_batch(N, comms, zs, ys, proofs, len(blobs))
    lhs, rhs = eip.verifier.batch_points(cs, zs, ys, pfs, r_powers)
    host_c = [B.g1_decompress(c) for c in comms]
    host_p = [B.g1_decompress(p) for p in proofs]
    y_lin = sum(r * y for r, y in zip(r_powers, ys)) % R_SCALAR
    want_lhs = B.g1_mul(g1s[0], -y_lin)
    want_rhs = None
    for c, p, r, z in zip(host_c, host_p, r_powers, zs):
        want_lhs = B.g1_add(want_lhs, B.g1_add(B.g1_mul(c, r) if c else None, B.g1_mul(p, r * z) if p else None))
        want_rhs = B.g1_add(want_rhs, B.g1_mul(p, r) if p else None)
    assert (lhs, rhs) == (want_lhs, want_rhs)


def test_table_free_route_matches_tables(setup, opening, monkeypatch):
    """FK20Config(fk20_window=None, commit_window=None): no table is built and
    the quotient's MSM runs msm.lincomb over the commit key; the same bytes
    as the table route."""

    def no_tables(*args, **kwargs):
        raise AssertionError("the table-free route built a fixed-base table")

    g1s, g2s, _, _, blobs = setup
    monkeypatch.setattr(M, "build_fixed_base_msm", no_tables)
    cfg = FK20Config(poly_len=N, coset_size=8, expansion=2, fk20_window=None, commit_window=None)
    free = DASContext(device="cpu", trusted_setup=TrustedSetup(g1s, g2s), config=cfg)
    assert free.prover.commit_tables is None and free.prover.commit_points is not None
    assert free.compute_kzg_proof(blobs[0], _scalar(opening[0])) == opening[1]


def _raises(cls, fn, *args):
    with pytest.raises(cls) as info:
        fn(*args)
    assert type(info.value) is cls
    return str(info.value)


def test_validation_order_and_errors(setup, ctx, commitments, blob_proofs):
    """Each call's checks in the JAX package's order, with its classes and
    texts: the blob before z, the commitment before the proof (single-point
    texts, no index), the proof's length after the commitment's value, the
    lists' lengths before any point, every point before the blobs."""
    blobs = setup[4]
    rnd = random.Random(18)
    off = off_curve_bytes(rnd)
    sub = not_in_subgroup_bytes(rnd)
    good_z = _scalar(5)
    bad_blob = blobs[0][:-32]
    proof0 = blob_proofs[0]
    blob_msg = _outcome(ser.deserialize_scalars, bad_blob, N)[1]
    off_msg = "x coordinate not on curve"
    sub_msg = "point not in the prime-order subgroup"
    S, V = E.SerializationError, E.VerifierError

    assert _raises(S, ctx.compute_kzg_proof, bad_blob, b"\x01") == blob_msg
    assert _raises(S, ctx.compute_kzg_proof, blobs[0], b"\x01") == "scalar has invalid length 1, expected 32"
    assert _raises(S, ctx.compute_kzg_proof, blobs[0], _scalar(R_SCALAR)) == "scalar is not canonical"
    assert _raises(S, ctx.compute_blob_kzg_proof, bad_blob, off) == blob_msg
    assert _raises(S, ctx.compute_blob_kzg_proof, blobs[0], off) == off_msg
    assert _raises(S, ctx.verify_kzg_proof, off, good_z, good_z, proof0[:47]) == off_msg
    assert _raises(S, ctx.verify_kzg_proof, commitments[0], good_z, _scalar(R_SCALAR + 1), proof0) == (
        "scalar is not canonical"
    )
    assert _raises(S, ctx.verify_blob_kzg_proof, bad_blob, commitments[0], sub) == sub_msg
    assert _raises(S, ctx.verify_blob_kzg_proof, bad_blob, commitments[0], proof0) == blob_msg
    batch = ctx.verify_blob_kzg_proof_batch
    assert _raises(V, batch, blobs, commitments, [proof0]) == (
        "batch verification inputs must have the same length: 2 blobs, 2 commitments, 1 proofs"
    )
    assert _raises(S, batch, [bad_blob, blobs[1]], [commitments[0], off], [sub, proof0]) == f"point 1: {off_msg}"
    assert _raises(S, batch, [bad_blob, blobs[1]], commitments, [proof0, sub]) == f"point 1: {sub_msg}"
    assert _raises(S, batch, [bad_blob, blobs[1]], commitments, [proof0, proof0]) == blob_msg
    if JN.available():
        assert (off_msg, sub_msg) == (_outcome(JSER.deserialize_g1, off)[1], _outcome(JSER.deserialize_g1, sub)[1])


def test_context4844_stands_alone(setup, ctx, commitments, blob_proofs):
    """Context4844 over the context's prover and setup gives the same
    commitment; over a setup without G2 points it proves (the same bytes)
    but refuses to verify."""
    g1s, g2s, _, _, blobs = setup
    eip = Context4844(ctx.prover, TrustedSetup(g1s, g2s))
    assert eip.blob_to_kzg_commitment(blobs[1]) == commitments[1]
    prover_only = Context4844(ctx.prover, TrustedSetup(g1s))
    assert prover_only.compute_blob_kzg_proof(blobs[1], commitments[1]) == blob_proofs[1]
    with pytest.raises(ValueError):
        prover_only.verify_blob_kzg_proof(blobs[1], commitments[1], blob_proofs[1])

"""The port's prover slice against the JAX package, byte for byte.

At the tests/test_fk20.py geometry (poly_len 64, cells of 8, windows 4), one
JAX FK20Prover is built and used by one test only, the last of this file:
on the CPU, XLA's compiles of the G1-FFT, the table build and the prove take
many minutes and many GB. The port proves the same blobs through
`DASContext(device="cpu")`, once on its own tables and once on the JAX
prover's tables carried over by utils/convert.py; cells, proofs and
commitments must equal the JAX package's bytes. The same test holds the
port's 16-point fft_g1 / ifft_g1 and its fixed-base MSM against the JAX
graphs that the prover has already compiled, on fresh inputs, and runs the
port's recovery and verifier on the JAX bytes: both blobs recovered from
half of their cells, JAX's proofs accepted, a swapped pair rejected. A host
oracle check and the package guards need no JAX graph.
"""

import ast
import hashlib
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_eth_kzg_tpu import api as JAPI
from rust_eth_kzg_tpu.errors import SerializationError as JaxSerializationError
from rust_eth_kzg_tpu.models import fk20 as JFK
from rust_eth_kzg_tpu.ops import curve as JC
from rust_eth_kzg_tpu.ops import field as JF
from rust_eth_kzg_tpu.utils import serialization as JSER
from rust_eth_kzg_tpu_torch import DASContext, TrustedSetup, api
from rust_eth_kzg_tpu_torch.constants import P, R_SCALAR
from rust_eth_kzg_tpu_torch.errors import InvalidProofError, SerializationError
from rust_eth_kzg_tpu_torch.models import naive
from rust_eth_kzg_tpu_torch.models.fk20 import FK20Config, FK20Prover, _circulant_index_map
from rust_eth_kzg_tpu_torch.ops import curve as C
from rust_eth_kzg_tpu_torch.ops import field as F
from rust_eth_kzg_tpu_torch.ops import msm as M
from rust_eth_kzg_tpu_torch.ops import ntt
from rust_eth_kzg_tpu_torch.utils import bls_host as B
from rust_eth_kzg_tpu_torch.utils import convert, trusted_setup

# One intra-op thread: the plain versions run many small tensor ops, and
# beside other busy processes (xdist workers, XLA compiles) a thread pool
# stalls each op until all its threads are scheduled.
torch.set_num_threads(1)

CFG = FK20Config(poly_len=64, coset_size=8, expansion=2, fk20_window=4, commit_window=4)
JCFG = JFK.FK20Config(poly_len=64, coset_size=8, expansion=2, fk20_window=4, commit_window=4)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "rust_eth_kzg_tpu_torch")


@pytest.fixture(scope="module")
def setup():
    g1s, g2s, tau = naive.insecure_setup(CFG.poly_len, CFG.coset_size + 1)
    rng = np.random.default_rng(20)
    coeffs = [int(v) ** 5 % R_SCALAR for v in rng.integers(1, 2**62, size=CFG.poly_len)]
    dom = ntt.Domain(CFG.poly_len, "cpu")
    evals = naive.ntt_host(coeffs, dom.generator)
    blob = b"".join(evals[int(r)].to_bytes(32, "big") for r in ntt.bitrev_indices(CFG.poly_len))
    return g1s, tau, coeffs, [blob, bytes(32 * CFG.poly_len)], g2s


@pytest.fixture(scope="module")
def jax_prover(setup):
    return JFK.FK20Prover(setup[0], JCFG)


def _joined(results):
    """(cells, proofs) per blob -> (concatenated cell bytes, proofs): the JAX
    helper cuts cells at the mainnet cell size whatever the geometry."""
    return [(b"".join(cells), tuple(proofs)) for cells, proofs in results]


@pytest.fixture(scope="module")
def jax_outputs(setup, jax_prover):
    blobs = setup[3]
    data = np.stack([JSER.deserialize_scalars(b, CFG.poly_len) for b in blobs], axis=1)
    packed = JFK._prove_packed_from_data(jax_prover, jax_prover.tables, jnp.asarray(data.astype(np.uint16)))
    k = CFG.num_proofs
    cells_std, px, py, inf = JFK.unpack_prove_outputs(np.asarray(packed), len(blobs), k, CFG.coset_size)
    proved = _joined(zip(JAPI._cells_bytes_from_std(cells_std), JAPI._proofs_bytes_from_std(px, py, inf, len(blobs), k)))
    poly = jax_prover.blob_to_poly(JF.to_mont(JF.FR, jnp.asarray(data)))
    commitments = [B.g1_compress(pt) for pt in JC.points_from_device(jax_prover.commit_from_poly(poly))]
    return proved, commitments, poly


@pytest.fixture(scope="module")
def port_ctx(setup):
    return DASContext(device="cpu", trusted_setup=TrustedSetup(setup[0], setup[4]), config=CFG)


@pytest.fixture(scope="module")
def port_outputs(setup, port_ctx):
    return port_ctx.compute_cells_and_kzg_proofs_batch(setup[3])


def _carried_tables(jax_prover):
    out = []
    for t in (jax_prover.tables, jax_prover.commit_tables):
        out.append(
            convert.fixed_base_tables_from_jax(
                np.asarray(t.table_rows), np.asarray(t.base_inf), t.window, t.chains, t.wpc, t.instance_ndim,
                "cpu",
            )
        )
    return tuple(out)


def test_matches_naive_oracle(setup, port_ctx, port_outputs):
    _, tau, coeffs, blobs, _ = setup
    cells, proofs = port_outputs[0]
    zero_cells, zero_proofs = port_outputs[1]
    assert all(c == bytes(32 * CFG.coset_size) for c in zero_cells)
    assert all(p == B.g1_compress(None) for p in zero_proofs)
    assert b"".join(cells[: CFG.poly_len // CFG.coset_size]) == blobs[0]
    ext = ntt.Domain(CFG.ext_size, "cpu")
    coset = ntt.Domain(CFG.coset_size, "cpu")
    rev = ntt.bitrev_indices(CFG.num_proofs)
    for k in range(CFG.num_proofs):
        hk = ext.roots[int(rev[k])]
        want, _ = naive.compute_multi_opening_naive(coeffs, [hk * w % R_SCALAR for w in coset.roots], tau)
        assert proofs[k] == B.g1_compress(want), k
    ext_evals = naive.ntt_host(coeffs + [0] * CFG.poly_len, ext.generator)
    want_cells = b"".join(ext_evals[int(r)].to_bytes(32, "big") for r in ntt.bitrev_indices(CFG.ext_size))
    assert b"".join(cells) == want_cells
    assert port_ctx.blob_to_kzg_commitment(blobs[0]) == B.g1_compress(naive.commit_with_tau(coeffs, tau))


def test_compute_cells_matches_prover(setup, port_ctx, port_outputs):
    assert port_ctx.compute_cells(setup[3][0]) == port_outputs[0][0]


def test_circulant_index_map_matches_jax():
    for poly_len, coset in ((64, 8), (4096, 64)):
        idx, mask = _circulant_index_map(poly_len, coset)
        jidx, jmask = JFK._circulant_index_map(poly_len, coset)
        assert np.array_equal(idx, jidx) and np.array_equal(mask, jmask)


def test_blob_validation_matches_jax(port_ctx):
    good = (5).to_bytes(32, "big") * CFG.poly_len
    bad_scalar = R_SCALAR.to_bytes(32, "big") + good[32:]
    for data in (bad_scalar, good[:-1], good + good):
        with pytest.raises(SerializationError):
            port_ctx.compute_cells_and_kzg_proofs(data)
        with pytest.raises(JaxSerializationError):
            JSER.deserialize_scalars(data, CFG.poly_len)
    with pytest.raises(SerializationError):
        port_ctx.compute_cells_and_kzg_proofs_batch([])


def test_das_context_requires_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        DASContext()
    with pytest.raises(RuntimeError):
        api.resolve_device("cuda")
    assert api.resolve_device("cpu") == torch.device("cpu")


def test_table_free_route_matches_tables(setup, port_ctx, port_outputs, monkeypatch):
    """FK20Config(fk20_window=None, commit_window=None) builds no fixed-base
    table and runs its MSMs by `lincomb`: its cells, proofs and commitment,
    and its recovery from half of the cells, equal the table route's bytes
    (held against JAX in test_slice_matches_jax)."""

    def no_tables(*args, **kwargs):
        raise AssertionError("the table-free route built a fixed-base table")

    monkeypatch.setattr(M, "build_fixed_base_msm", no_tables)
    cfg = FK20Config(poly_len=64, coset_size=8, expansion=2, fk20_window=None, commit_window=None)
    free = DASContext(device="cpu", trusted_setup=TrustedSetup(setup[0], setup[4]), config=cfg)
    assert free.prover.tables is None and free.prover.commit_tables is None
    blob = setup[3][0]
    assert free.compute_cells_and_kzg_proofs(blob) == port_outputs[0]
    assert free.blob_to_kzg_commitment(blob) == port_ctx.blob_to_kzg_commitment(blob)
    cells = port_outputs[0][0]
    keep = list(range(1, CFG.num_proofs, 2))
    assert free.recover_cells_and_kzg_proofs(keep, [cells[i] for i in keep]) == port_outputs[0]


def test_use_precomp_none_is_the_table_free_route(monkeypatch):
    """DASContext(use_precomp=None) asks for mainnet geometry with no tables
    (the prover is stubbed: no mainnet context is built on the CPU); an
    explicit use_precomp beside a config is refused, the default is not."""
    seen = []

    class Stop(Exception):
        pass

    def prover(points, config, device, **kwargs):
        seen.append(config)
        raise Stop

    monkeypatch.setattr(api, "FK20Prover", prover)
    for kwargs in ({"use_precomp": None}, {}, {"use_precomp": 6}, {"config": CFG}):
        with pytest.raises(Stop):
            DASContext(device="cpu", trusted_setup=TrustedSetup([None] * 4096), **kwargs)
    assert [(c.poly_len, c.fk20_window, c.commit_window) for c in seen] == [
        (4096, None, None), (4096, 8, 8), (4096, 6, 6), (64, 4, 4),
    ]
    for width in (None, 8):
        with pytest.raises(ValueError):
            DASContext(device="cpu", use_precomp=width, config=CFG)


def _sources():
    for root, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


def test_port_imports_nothing_of_jax():
    for path in _sources():
        with open(path) as fh:
            tree = ast.parse(fh.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            elif isinstance(node, ast.Call) and getattr(node.func, "id", "") == "__import__":
                names = [a.value for a in node.args if isinstance(a, ast.Constant)]
            else:
                continue
            for name in names:
                root = name.split(".")[0]
                assert root not in ("jax", "jaxlib", "rust_eth_kzg_tpu"), f"{path} imports {name}"


def test_trusted_setup_copy_is_identical(tmp_path, monkeypatch):
    monkeypatch.setattr(trusted_setup, "CACHE_DIR", str(tmp_path))  # default()'s cache, out of the tree

    def digest(path):
        with open(path, "rb") as fh:
            return hashlib.sha256(fh.read()).hexdigest()

    jax_copy = os.path.join(REPO, "rust_eth_kzg_tpu", "data", "trusted_setup_4096.json")
    port_copy = os.path.join(PORT, "data", "trusted_setup_4096.json")
    assert digest(port_copy) == digest(jax_copy)
    g1 = TrustedSetup.default().g1_monomial
    assert len(g1) == 4096 and g1[0] == B.G1_GEN


def _jax_affine(p):
    """JAX projective G1 (any lazy bound) -> host affine points, flattened."""
    xs, ys, zs = (JC.FP.from_mont_host(np.asarray(c).reshape(c.shape[0], -1)) for c in p)
    return [None if z == 0 else (x * pow(z, -1, P) % P, y * pow(z, -1, P) % P) for x, y, z in zip(xs, ys, zs)]


def _check_g1_transforms(jax_prover, port_ctx):
    """fft_g1 and ifft_g1(take_n=k, prescaled=True) over the 2k = 16-point
    circulant domain at the [coset, 2k] shape the JAX prover compiled in its
    init. The JAX inverse comes from its forward transform: the unscaled
    inverse DFT is out[i] = fwd[-i mod n] (JAX's own ifft_g1 is a further
    compile of minutes on the CPU)."""
    cfg = CFG
    k = cfg.poly_len // cfg.coset_size
    rng = np.random.default_rng(21)
    pts = [B.g1_mul(B.G1_GEN, int(v)) for v in rng.integers(1, 2**62, size=cfg.coset_size * 2 * k)]
    pts[3] = pts[2 * k + 5] = None  # identity inputs
    pts[7] = B.g1_neg(pts[6])
    jdev = JC.points_to_device(pts)
    jdev = JC.G1(*(c.reshape(-1, cfg.coset_size, 2 * k) for c in jdev))
    jfwd = jax_prover.circulant_domain.fft_g1(jdev)
    dom = port_ctx.prover.circulant_domain
    pdev = C._map(lambda c: c.reshape(-1, cfg.coset_size, 2 * k), C.points_to_device(pts, "cpu"))
    assert C.points_from_device(dom.fft_g1(pdev)) == _jax_affine(jfwd)
    neg_idx = np.array([(-i) % (2 * k) for i in range(k)])
    jinv = JC.G1(*(np.asarray(c)[..., neg_idx] for c in jfwd))
    assert C.points_from_device(dom.ifft_g1(pdev, take_n=k, prescaled=True)) == _jax_affine(jinv)


def _check_fixed_base_msm(jax_prover, port_ctx, jpoly):
    """The commit-key fixed-base MSM on fresh scalars (0, 1, r - 1 and
    2^255 mod r among them) through JAX's compiled commit graph."""
    rng = np.random.default_rng(22)
    n = jpoly.shape[1] * jpoly.shape[2]
    vals = [int(v) ** 5 % R_SCALAR for v in rng.integers(1, 2**62, size=n)]
    vals[:4] = [0, 1, R_SCALAR - 1, (1 << 255) % R_SCALAR]
    vals[CFG.poly_len :] = [0] * (n - CFG.poly_len)  # the second set commits to zero
    jscalars = jnp.asarray(JF.FR.to_mont_host(vals).reshape(jpoly.shape)).astype(jpoly.dtype)
    want = _jax_affine(JFK._commit_from_poly(jax_prover, jax_prover.commit_tables, jscalars))
    scalars = torch.from_numpy(F.FR.to_mont_host(vals)).reshape((F.FR.nlimbs,) + tuple(jpoly.shape[1:]))
    assert C.points_from_device(M.fixed_base_msm(port_ctx.prover.commit_tables, scalars)) == want
    assert want[1] is None and want[0] is not None


def _check_recover_and_verify(port_ctx, proved, commitments):
    """The port recovers both JAX blobs from 8 of their 16 cells (a seeded
    pattern each) byte for byte, accepts JAX's proofs of both blobs in one
    batch and rejects blob 0's batch with two proofs swapped."""
    size = 32 * CFG.coset_size
    cells = [[joined[i : i + size] for i in range(0, len(joined), size)] for joined, _ in proved]
    proofs = [list(p) for _, p in proved]
    rng = np.random.default_rng(23)
    batches = []
    for c in cells:
        idx = sorted(int(i) for i in rng.choice(CFG.num_proofs, size=CFG.num_proofs // 2, replace=False))
        batches.append((idx, [c[i] for i in idx]))
    assert batches[0][0] != batches[1][0]
    recovered = port_ctx.recover_cells_and_kzg_proofs_batch(batches)
    assert [(list(rc), list(rp)) for rc, rp in recovered] == list(zip(cells, proofs))
    n = CFG.num_proofs
    port_ctx.verify_cell_kzg_proof_batch(
        [commitments[0]] * n + [commitments[1]] * n, list(range(n)) * 2, cells[0] + cells[1], proofs[0] + proofs[1]
    )
    swapped = list(proofs[0])
    swapped[1], swapped[2] = swapped[2], swapped[1]
    with pytest.raises(InvalidProofError):
        port_ctx.verify_cell_kzg_proof_batch([commitments[0]] * n, list(range(n)), cells[0], swapped)


def test_slice_matches_jax(setup, port_ctx, port_outputs, jax_prover, jax_outputs):
    """Tables, cells, proofs and commitments equal the JAX package's, with the
    port's own tables and with the JAX prover's tables carried over; so do
    the G1 transforms and the fixed-base MSM on fresh inputs; the port's
    recovery and verifier agree with the JAX bytes. One test, so that a run
    over several workers builds the JAX prover once."""
    carried = _carried_tables(jax_prover)
    for mine, theirs in zip((port_ctx.prover.tables, port_ctx.prover.commit_tables), carried):
        assert (mine.window, mine.chains, mine.wpc, mine.instance_ndim) == (
            theirs.window, theirs.chains, theirs.wpc, theirs.instance_ndim,
        )
        assert torch.equal(mine.base_inf, theirs.base_inf)
        assert torch.equal(mine.table_x, theirs.table_x)
        assert torch.equal(mine.table_y, theirs.table_y)

    proved, commitments, jpoly = jax_outputs
    assert all(len(cells) == CFG.num_proofs for cells, _ in port_outputs)
    assert _joined(port_outputs) == proved
    carried_ctx = DASContext.from_prover(FK20Prover(None, CFG, "cpu", tables=carried))
    assert _joined(carried_ctx.compute_cells_and_kzg_proofs_batch(setup[3])) == proved
    assert [port_ctx.blob_to_kzg_commitment(b) for b in setup[3]] == commitments
    _check_g1_transforms(jax_prover, port_ctx)
    _check_fixed_base_msm(jax_prover, port_ctx, jpoly)
    _check_recover_and_verify(port_ctx, proved, commitments)

"""The port's multi-device layer (rust_eth_kzg_tpu_torch/parallel/mesh.py)
against the JAX package and the single-device port, exactly.

Each world is 2 or 4 gloo ranks on the CPU, spawned by
tests/torch_mesh_ranks.py with a 120 s limit. At the tests/test_mesh.py
geometry (poly_len 64, cells of 8, windows 4):
- `fft_sharded` at n = 64 over 2 and 4 ranks equals JAX's `fft_sharded`
  over the 8 virtual CPU devices;
- `lincomb_sharded` at N = 16, with an identity point and a zero scalar,
  equals the port's `lincomb` and a host oracle (JAX's takes minutes to
  compile on the CPU, so it is not run);
- `prove_sharded` (4 ranks) and `prove_work_sharded` (a (2, 2) mesh), each
  a world of its own, equal the unsharded prover's `prove_from_data`, both
  reading their tables from a snapshot; the sharded prover keeps half of
  the FK20 tables;
- `DASContext(mesh=...)` on a (1, 2) mesh, built from the setup, proves and
  recovers the same bytes as the unsharded context.
The reference proves while the ranks of a world run.
"""

import random
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_eth_kzg_tpu import api as JAPI
from rust_eth_kzg_tpu import errors as JE
from rust_eth_kzg_tpu.ops import field as JF
from rust_eth_kzg_tpu.ops import ntt as JNTT
from rust_eth_kzg_tpu.parallel import mesh as JMESH
from rust_eth_kzg_tpu_torch import DASContext, TrustedSetup
from rust_eth_kzg_tpu_torch.constants import R_SCALAR
from rust_eth_kzg_tpu_torch.models import naive
from rust_eth_kzg_tpu_torch.ops import curve as C
from rust_eth_kzg_tpu_torch.ops import field as F
from rust_eth_kzg_tpu_torch.ops import msm as M
from rust_eth_kzg_tpu_torch.parallel import mesh as PM
from rust_eth_kzg_tpu_torch.utils import bls_host as B

from . import torch_mesh_ranks as R

# One intra-op thread here and in every rank (see tests/test_torch_fk20.py).
torch.set_num_threads(1)

CFG = R.CFG
FR = F.FR


@pytest.fixture(scope="module")
def setup():
    g1s, g2s, _ = naive.insecure_setup(CFG.poly_len, CFG.coset_size + 1)
    rng = np.random.default_rng(81)
    blobs = [b"".join(int(v).to_bytes(32, "big") for v in rng.integers(0, 2**62, size=CFG.poly_len))
             for _ in range(4)]
    return g1s, g2s, blobs


@pytest.fixture(scope="module")
def reference(setup, tmp_path_factory):
    """The unsharded context and a snapshot of its tables."""
    g1s, g2s, _ = setup
    ctx = DASContext(device="cpu", trusted_setup=TrustedSetup(g1s, g2s), config=CFG)
    cache = str(tmp_path_factory.mktemp("tables") / "tables.bin")
    ctx.save_tables(cache)
    return ctx, cache


@pytest.fixture(scope="module")
def reference_bytes(setup, reference):
    """The unsharded context's cells and proofs of the setup's 4 blobs."""
    return reference[0].compute_cells_and_kzg_proofs_batch(setup[2])


def test_make_mesh_needs_a_process_group():
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        PM.make_mesh()


@pytest.mark.parametrize("world", [2, 4])
def test_fft_sharded_matches_jax(world, tmp_path):
    rnd = random.Random(32)
    n = 64
    xs = [rnd.randrange(R_SCALAR) for _ in range(2 * n)]
    x = torch.from_numpy(FR.to_mont_host(xs)).reshape(FR.nlimbs, 2, n)
    started = R.start_world(R.fft_program, world, tmp_path, x, n)
    mesh = JMESH.make_mesh(8, devices=jax.devices("cpu"))
    xj = jnp.asarray(JF.FR.to_mont_host(xs)).reshape(JF.FR.nlimbs, 2, n)
    got = JMESH.fft_sharded(JNTT.domain(n), xj, mesh, axis="work")
    want = JF.FR.from_mont_host(np.asarray(got).reshape(JF.FR.nlimbs, -1))
    results = R.join_world(started)
    assert all(r == want for r in results)


def test_lincomb_sharded_matches_oracle(tmp_path):
    rnd = random.Random(31)
    n = 16
    pts = [B.g1_mul(B.G1_GEN, rnd.randrange(1, R_SCALAR)) for _ in range(n)]
    pts[3] = None
    scal = [rnd.randrange(R_SCALAR) for _ in range(n)]
    scal[5] = 0
    sm = torch.from_numpy(FR.to_mont_host(scal))
    started = R.start_world(R.lincomb_program, 4, tmp_path, pts, sm)
    single = C.points_from_device(C._map(lambda c: c[:, None], M.lincomb(C.points_to_device(pts, "cpu"), sm)))[0]
    oracle = None
    for p, k in zip(pts, scal):
        oracle = B.g1_add(oracle, B.g1_mul(p, k))
    assert single == oracle
    assert R.join_world(started) == [oracle] * 4


def test_prove_sharded_matches_single(setup, reference, request, tmp_path):
    g1s, _, blobs = setup
    ctx, cache = reference
    started = R.start_world(R.prove_sharded_program, 4, tmp_path, g1s, cache, ctx._data(blobs))
    want = request.getfixturevalue("reference_bytes")
    assert R.join_world(started) == [want] * 4


def test_prove_work_sharded_matches_single(setup, reference, request, tmp_path):
    g1s, _, blobs = setup
    ctx, cache = reference
    started = R.start_world(R.prove_work_sharded_program, 4, tmp_path, g1s, cache, ctx._data(blobs[:2]))
    want = request.getfixturevalue("reference_bytes")[:2]
    results = R.join_world(started)
    # JAX's message for a batch of 3 on a dp = 2 mesh, raised before any
    # device work (rust_eth_kzg_tpu/api.py:329-337)
    fake = SimpleNamespace(mesh=SimpleNamespace(shape={"dp": 2, "work": 2}))
    with pytest.raises(JE.ProverError) as exc:
        JAPI.DASContext._prove_packed_sharded(fake, jnp.zeros((JF.FR.nlimbs, 3, CFG.poly_len), jnp.int32))
    for r in results:
        assert r["proved"] == want
        # the rank keeps 8 of the 16 slots, cut from the whole snapshot
        assert 2 * r["fk20_table_bytes"] == ctx.prover.tables.nbytes
        assert r["dp_error"] == str(exc.value)
        assert "cannot save" in r["save_error"]
    assert [r["slots"] for r in results] == [(0, 8), (8, 16), (0, 8), (8, 16)]


def test_das_context_mesh_matches_unsharded(setup, request, tmp_path):
    g1s, g2s, blobs = setup
    kept = sorted(random.Random(83).sample(range(CFG.num_proofs), CFG.num_proofs // 2))
    started = R.start_world(R.context_program, 2, tmp_path, g1s, g2s, blobs[:1], kept)
    ctx = request.getfixturevalue("reference")[0]
    want = request.getfixturevalue("reference_bytes")[:1]
    results = R.join_world(started)
    for r in results:
        assert r["mesh_shape"] == (1, 2)
        assert r["proved"] == want
        assert r["recovered"] == want[0]
        # the rank built its 8 of 16 slots' tables: half of the FK20 bytes
        assert r["table_instances"] == CFG.num_proofs // 2
        assert 2 * r["fk20_table_bytes"] == ctx.prover.tables.nbytes
    # the unsharded context keeps every slot
    assert ctx.mesh is None and (ctx.prover.slots.start, ctx.prover.slots.stop) == (0, CFG.num_proofs)
    assert ctx.prover.tables.table_x.shape[1] == CFG.num_proofs


def test_sharded_calls_refuse_a_mismatched_prover():
    with pytest.raises(ValueError, match="sharded over this mesh"):
        PM.prove_work_sharded(SimpleNamespace(mesh=None), object(), None)
    with pytest.raises(ValueError, match="every slot"):
        PM.prove_sharded(SimpleNamespace(mesh=object()), None, None)

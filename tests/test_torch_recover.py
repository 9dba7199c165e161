"""The port's recovery pieces (rust_eth_kzg_tpu_torch, CPU plain versions)
against the JAX package, exactly.

Host pieces (coset bookkeeping, the vanishing polynomial, cell bytes, the
API's input validation) are compared value for value and error class for
error class. The device recovery (five NTTs, the batched Fr inversion and
the degree check) runs at the tests/test_reed_solomon.py geometry,
ReedSolomon(32, 2, 16), where the JAX graph is the one that test compiles.
The byte-level recovery of JAX-proved blobs is held in
tests/test_torch_fk20.py::test_slice_matches_jax.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_eth_kzg_tpu import api as JAPI
from rust_eth_kzg_tpu import errors as JE
from rust_eth_kzg_tpu.models import cosets as JCOS
from rust_eth_kzg_tpu.models.reed_solomon import ReedSolomon as JReedSolomon
from rust_eth_kzg_tpu.ops import field as JF
from rust_eth_kzg_tpu.ops import limbs as JL
from rust_eth_kzg_tpu.utils import serialization as JSER
from rust_eth_kzg_tpu_torch import api
from rust_eth_kzg_tpu_torch import errors as E
from rust_eth_kzg_tpu_torch.constants import R_SCALAR
from rust_eth_kzg_tpu_torch.models import cosets
from rust_eth_kzg_tpu_torch.models import naive
from rust_eth_kzg_tpu_torch.models.fk20 import FK20Config
from rust_eth_kzg_tpu_torch.models.reed_solomon import ReedSolomon
from rust_eth_kzg_tpu_torch.ops import field as F
from rust_eth_kzg_tpu_torch.ops import limbs as LB
from rust_eth_kzg_tpu_torch.ops import ntt
from rust_eth_kzg_tpu_torch.utils import serialization as ser

# One intra-op thread: the plain versions run many small tensor ops, and
# beside other busy processes (xdist workers, XLA compiles) a thread pool
# stalls each op until all its threads are scheduled.
torch.set_num_threads(1)

FR = F.FR
MAINNET = FK20Config()
SMALL = FK20Config(poly_len=64, coset_size=8, expansion=2, fk20_window=4, commit_window=4)


def _jax_ints(limbs):
    return JL.limbs_to_ints(np.asarray(limbs).reshape(np.asarray(limbs).shape[0], -1))


def _port_ints(limbs):
    arr = np.asarray(limbs)
    return LB.limbs_to_ints(arr.reshape(arr.shape[0], -1))


def _scalars(n, seed):
    rng = np.random.default_rng(seed)
    return [int(v) ** 5 % R_SCALAR for v in rng.integers(1, 2**62, size=n)]


def test_cosets_match_jax():
    for n, bits in ((5, 3), (0, 7), (127, 7), (64, 7)):
        assert cosets.reverse_bits(n, bits) == JCOS.reverse_bits(n, bits)
    for points, num in ((8192, 128), (128, 16)):
        for rev in (False, True):
            assert cosets.coset_gens(points, num, rev) == JCOS.coset_gens(points, num, rev)
    rng = np.random.default_rng(1)
    evals = rng.integers(0, 2**31, size=(5, 8, 3)).astype(np.int32)
    idx = [0, 3, 4, 9, 15]
    got = cosets.recover_evaluations_in_domain_order(128, idx, evals)
    want = JCOS.recover_evaluations_in_domain_order(128, idx, evals)
    assert got[0] == want[0] and np.array_equal(got[1], want[1])
    for bad in ([], [0, 16, 1, 2, 3]):
        assert cosets.recover_evaluations_in_domain_order(128, bad, evals[: len(bad)]) is None
        assert JCOS.recover_evaluations_in_domain_order(128, bad, evals[: len(bad)]) is None


@pytest.mark.parametrize("geometry", [(32, 2, 16), (4096, 2, 128)], ids=["small", "mainnet"])
def test_vanishing_polynomial_matches_jax(geometry):
    port, jax_rs = ReedSolomon(*geometry, "cpu"), JReedSolomon(*geometry)
    assert port.acceptable_num_block_erasures == jax_rs.acceptable_num_block_erasures
    rnd = random.Random(geometry[0])
    patterns = [[], [0], sorted(rnd.sample(range(geometry[2]), port.acceptable_num_block_erasures))]
    for missing in patterns:
        small = port.construct_vanishing_poly_small(missing)
        assert _port_ints(small) == _jax_ints(jax_rs.construct_vanishing_poly_small(missing))
        assert _port_ints(port.spread_vanishing(torch.from_numpy(small)).numpy()) == _jax_ints(
            jax_rs.construct_vanishing_poly(missing)
        )
    for bad in (list(range(port.acceptable_num_block_erasures + 1)), [geometry[2]]):
        with pytest.raises(E.RecoveryError):
            port.construct_vanishing_poly_small(bad)
        with pytest.raises(JE.RecoveryError):
            jax_rs.construct_vanishing_poly_small(bad)


def _cell(values):
    return b"".join(v.to_bytes(32, "big") for v in values)


def test_deserialize_cells_batch_matches_jax():
    cells = [_cell(_scalars(64, s)) for s in range(3)] + [_cell([0] * 63 + [R_SCALAR - 1])]
    got = ser.deserialize_cells_batch(cells)
    want = JSER.deserialize_cells_batch(cells)
    assert got.shape[:2] == want.shape[:2] == (4, 64)
    assert _port_ints(np.moveaxis(got, -1, 0)) == _jax_ints(np.moveaxis(want, -1, 0))
    non_canonical = cells[:1] + [_cell([R_SCALAR] + [0] * 63)]
    for bad in (non_canonical, [cells[0][:-1]], [cells[0] + b"\0"]):
        with pytest.raises(E.SerializationError):
            ser.deserialize_cells_batch(bad)
        with pytest.raises(JE.SerializationError):
            JSER.deserialize_cells_batch(bad)
    assert ser.deserialize_cells_batch([c[:256] for c in cells], 256).shape == (4, 8, 8)


def _mainnet_cells(seed):
    rng = np.random.default_rng(seed)
    return [_cell([int(v) for v in rng.integers(0, 2**62, size=64)]) for _ in range(128)]


def test_recover_inputs_match_jax():
    """Validation order, error classes and the erasure layout at mainnet
    geometry (host only: the JAX method reads no state of its context)."""
    cells = _mainnet_cells(3)
    keep = sorted(random.Random(4).sample(range(128), 70))
    e_std, missing = api.recover_inputs(MAINNET, keep, [cells[i] for i in keep])
    je_std, jmissing = JAPI.DASContext._recover_inputs(None, keep, [cells[i] for i in keep])
    assert missing == jmissing and len(missing) == 58
    assert _port_ints(e_std) == _jax_ints(je_std)
    bad_cells = [cells[i] for i in keep]
    bad_cells[3] = _cell([R_SCALAR] + [0] * 63)
    cases = [
        (keep[:-1], [cells[i] for i in keep]),  # length mismatch
        (keep[:-1] + [128], [cells[i] for i in keep]),  # index out of range
        ([keep[1], keep[0]] + keep[2:], [cells[i] for i in keep]),  # unsorted
        ([keep[0]] + keep[:-1], [cells[i] for i in keep]),  # duplicate
        (keep[:63], [cells[i] for i in keep[:63]]),  # too few
        (keep, bad_cells),  # non-canonical scalar
        (keep, [c[:-1] for c in bad_cells]),  # cell length
    ]
    for idx, cs in cases:
        with pytest.raises(E.Error) as got:
            api.recover_inputs(MAINNET, idx, cs)
        with pytest.raises(JE.Error) as want:
            JAPI.DASContext._recover_inputs(None, idx, cs)
        assert type(got.value).__name__ == type(want.value).__name__
        if isinstance(got.value, E.RecoveryError):  # the byte codecs word theirs apart
            assert str(got.value) == str(want.value)


def test_recover_inputs_small_geometry():
    cells = [_cell(_scalars(8, s)) for s in range(16)]
    e_std, missing = api.recover_inputs(SMALL, list(range(0, 16, 2)), cells[0:16:2])
    assert e_std.shape == (8, 128) and len(missing) == 8
    for idx in ([1, 0] + list(range(2, 8)), [0, 0] + list(range(2, 8)), list(range(7))):
        with pytest.raises(E.RecoveryError):
            api.recover_inputs(SMALL, idx, [cells[i] for i in idx])
    with pytest.raises(E.RecoveryError):
        api.recover_inputs(SMALL, list(range(16)) + [16], cells + cells[:1])


RS_GEOMETRY = (32, 2, 16)


def _vanishing(rs, missing):
    """Z of the missing block indices, standard-form limbs [8, n]."""
    return rs.spread_vanishing(torch.from_numpy(rs.construct_vanishing_poly_small(missing)))


def _erased_codeword(missing, corrupt=False):
    rs = ReedSolomon(*RS_GEOMETRY, "cpu")
    rnd = random.Random(len(missing))
    poly = [rnd.randrange(R_SCALAR) for _ in range(rs.poly_len)]
    dom = ntt.Domain(rs.codeword_length, "cpu")
    codeword = [naive.poly_eval_host(poly, w) for w in dom.roots]
    for m in range(rs.num_blocks):
        for b in missing:
            codeword[b + m * rs.block_size] = 0
    if corrupt:
        present = next(i for i in range(rs.codeword_length) if i % rs.block_size not in missing)
        codeword[present] = (codeword[present] + 1) % R_SCALAR
    return poly, codeword


@pytest.mark.parametrize("case", ["one", "max", "corrupt"])
def test_rs_recover_device_matches_jax(case):
    """recover_device against JAX's _recover_device on the same codeword:
    the canonical coefficients and the degree flag; a corrupted codeword
    fails the degree check in both."""
    rs, jrs = ReedSolomon(*RS_GEOMETRY, "cpu"), JReedSolomon(*RS_GEOMETRY)
    jrs.evaluation_domain  # the JAX domain cache must be filled outside a trace
    # with the most erasures no redundancy is left to expose a corruption
    nmiss = {"one": 1, "max": rs.acceptable_num_block_erasures, "corrupt": 3}[case]
    missing = sorted(random.Random(nmiss).sample(range(rs.block_size), nmiss))
    poly, codeword = _erased_codeword(missing, corrupt=case == "corrupt")
    e = torch.from_numpy(FR.to_mont_host(codeword))[:, None, :]
    got, ok = rs.recover_device(e, _vanishing(rs, missing))
    je = jnp.asarray(JF.FR.to_mont_host(codeword))[:, None, :]
    want, jok = jrs._recover_device(je, jnp.asarray(jrs.construct_vanishing_poly(missing)))
    assert ok.tolist() == np.asarray(jok).tolist() == [case != "corrupt"]
    assert FR.from_mont_host(got.reshape(8, -1).numpy()) == JF.FR.from_mont_host(np.asarray(want).reshape(-1, rs.codeword_length))
    e_std = torch.from_numpy(LB.ints_to_limbs(codeword, FR.nlimbs))[:, None, :]
    z_small = torch.from_numpy(rs.construct_vanishing_poly_small(missing))[:, None, :]
    rec, ok = rs.recover_polynomial_coefficient(e_std, z_small)
    assert ok.tolist() == [case != "corrupt"]
    if case != "corrupt":
        assert FR.from_mont_host(rec.reshape(8, -1).numpy()) == poly


def test_rs_recover_batch_per_blob_patterns():
    """Two blobs with their own erasure patterns in one call, the second one
    corrupted: only its degree check fails, and the API's error names it
    alone."""
    rs = ReedSolomon(*RS_GEOMETRY, "cpu")
    rows, zs, polys = [], [], []
    for missing, corrupt in (([2, 5], False), ([0, 7, 9], True)):
        poly, codeword = _erased_codeword(missing, corrupt)
        polys.append(poly)
        rows.append(LB.ints_to_limbs(codeword, FR.nlimbs))
        zs.append(rs.construct_vanishing_poly_small(missing))
    e_std = torch.from_numpy(np.stack(rows, axis=1))
    z_small = torch.from_numpy(np.stack(zs, axis=1))
    rec, ok = rs.recover_polynomial_coefficient(e_std, z_small)
    assert ok.tolist() == [True, False]
    assert FR.from_mont_host(rec[:, :1].reshape(8, -1).numpy()) == polys[0]
    assert torch.equal(rs.spread_vanishing(z_small)[:, 1], _vanishing(rs, [0, 7, 9]))
    with pytest.raises(E.RecoveryError, match=r"batch entries \[1\]"):
        api.DASContext.recovery_outputs(None, ok, None, None)  # raises before it reads the context

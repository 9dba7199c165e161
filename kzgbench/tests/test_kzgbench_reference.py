"""The reference agrees with the port at a small geometry on the CPU, and
with the stand-in, whose proofs are [q(tau)]_1 for a known tau."""

import random

import pytest
import torch

from conftest import SMALL, TAU

from kzgbench.reference import kzg as REF

torch.set_num_threads(1)
GEOM = REF.Geometry(SMALL["field_elements_per_blob"], SMALL["field_elements_per_cell"])


def _blobs(seed, count):
    rng = random.Random(seed)
    return [REF.scalars_to_bytes(rng.randrange(REF.R) for _ in range(GEOM.n)) for _ in range(count)]


def test_cells_and_openings_against_standin(standin, small_setup):
    blobs = _blobs(1, 3)
    out = standin.compute_cells_and_kzg_proofs_batch(blobs)
    assert REF.cells_wrong(GEOM, blobs, [o[0] for o in out]) == [0, 0, 0]
    # the first half of the cells is the blob itself
    assert all(b"".join(o[0][: GEOM.cells // 2]) == b for o, b in zip(out, blobs))
    judge = REF.Judge(GEOM, small_setup, 7)
    comms = [standin.blob_to_kzg_commitment(b) for b in blobs]
    proofs = [list(o[1]) for o in out]
    assert judge.openings_hold(blobs, proofs, comms)
    swapped = [list(p) for p in proofs]
    swapped[2][3], swapped[2][4] = swapped[2][4], swapped[2][3]
    assert not judge.openings_hold(blobs, swapped)
    assert not judge.openings_hold(blobs, proofs, [comms[1], comms[0], comms[2]])
    assert not judge.openings_hold(blobs, [p[:-1] for p in proofs])


def test_msm_and_decompress():
    pts = REF.insecure_setup_g1(9, 3)
    assert [REF.decompress(REF.compress(p)) for p in pts] == pts
    assert REF.decompress(REF.compress(None)) is None
    ks = [random.Random(k).getrandbits(200) for k in range(9)]
    want = REF.INF
    for p, k in zip(pts, ks):
        q = REF.scalar_mul(p, k)
        want = REF._add(want, (q[0], q[1], 1))
    assert REF.msm(pts, ks) == REF.to_affine(want)
    with pytest.raises(ValueError):
        REF.decompress(bytes(48))


@pytest.fixture(scope="module")
def port():
    from rust_eth_kzg_tpu_torch import DASContext, FK20Config, TrustedSetup
    from rust_eth_kzg_tpu_torch.models import naive

    g1s, g2s, _ = naive.insecure_setup(GEOM.n, 9, TAU)
    return DASContext(device="cpu", trusted_setup=TrustedSetup(g1s, g2s),
                      config=FK20Config(GEOM.n, GEOM.m, 2, SMALL["precomp_width"], SMALL["precomp_width"]))


def test_reference_agrees_with_the_port(port, small_setup):
    blobs = _blobs(2, 2)
    out = port.compute_cells_and_kzg_proofs_batch(blobs)
    assert REF.cells_wrong(GEOM, blobs, [o[0] for o in out]) == [0, 0]
    comms = [port.blob_to_kzg_commitment(b) for b in blobs]
    judge = REF.Judge(GEOM, small_setup, 8)
    assert judge.openings_hold(blobs, [list(o[1]) for o in out], comms)
    kept = sorted(random.Random(3).sample(range(GEOM.cells), GEOM.cells // 2))
    rec = port.recover_cells_and_kzg_proofs_batch([(kept, [out[0][0][k] for k in kept])])
    assert REF.cells_wrong(GEOM, blobs[:1], [rec[0][0]]) == [0]
    assert judge.openings_hold(blobs[:1], [list(rec[0][1])])

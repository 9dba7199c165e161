"""The traffic generator: the same seed gives the same bytes, every scalar
is canonical, and every seed gets the same sizes."""

import numpy as np

from kzgbench import registry
from kzgbench.pacing import poisson
from kzgbench.reference import kzg as REF
from kzgbench.traffic import das


def test_same_seed_same_blobs_and_canonical():
    a = das.make_blobs(np.random.default_rng(2**31 + 17), 3, 4096)
    b = das.make_blobs(np.random.default_rng(2**31 + 17), 3, 4096)
    c = das.make_blobs(np.random.default_rng(2**31 + 18), 3, 4096)
    assert a == b and a != c
    assert all(len(x) == 4096 * 32 for x in a)
    for blob in a:
        REF.scalars_from_bytes(blob)  # raises on a scalar >= r


def test_bump_keeps_canonical():
    cell = (REF.R - 1).to_bytes(32, "big") * 2
    out = das.bump_scalar(cell, 0)
    assert out[:32] == bytes(32) and out[32:] == cell[32:]


def test_pools_same_for_same_seed(standin):
    conf = {"field_elements_per_blob": 64, "field_elements_per_cell": 8, "precomp_width": 4}
    params = {"entry": "verify", "blobs_per_call": 2, "pool_calls": 3, "order": "column-major", "invalid_calls": 1}
    p1 = das.make(params, conf, 5, standin)
    p2 = das.make(params, conf, 5, standin)
    p3 = das.make(params, conf, 6, standin)
    assert p1.args == p2.args and p1.invalid == p2.invalid
    assert p1.args != p3.args
    assert [len(a[2]) for a in p1.args] == [len(a[2]) for a in p3.args] == [32] * 3
    assert len(p1.invalid) == len(p3.invalid) == 1


def test_every_cell_pool_has_its_sizes():
    bench = registry.benchmark()
    for w in bench["workloads"]:
        cell = registry.cell(w["name"])
        p = cell["params"]
        assert p["blobs_per_call"] >= 1 and p["pool_calls"] >= 1
        if p["entry"] == "verify":
            assert p["blobs_per_call"] <= cell["configuration"].get(
                "max_blobs_per_tx", cell["configuration"].get("max_blobs_per_block"))


def test_poisson_arrivals_same_set_for_every_seed():
    a, b = poisson.gaps(25.0, 200, 2**31 + 1), poisson.gaps(25.0, 200, 2**31 + 2)
    assert a == poisson.gaps(25.0, 200, 2**31 + 1) and a != b and sorted(a) == sorted(b)
    assert abs(sum(a) / len(a) - 1 / 25.0) < 0.3 / 25.0

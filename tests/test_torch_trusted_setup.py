"""The port's trusted setup and its decompressed-point cache
(rust_eth_kzg_tpu_torch/utils/trusted_setup.py) against the JAX package's
parse.

The cache directory is pointed at pytest's tmp_path in every test, so
nothing is written into the tree. One port parse and one JAX parse of the
embedded mainnet JSON are shared by the module; the JAX side is its
`TrustedSetup.from_json_unchecked` (its `default()` would write into the JAX
package's `data/`). The other tests use a small JSON of insecure-setup
points compressed with bls_host.
"""

import json
import os
import re
import threading

import pytest
import torch

from rust_eth_kzg_tpu.utils import trusted_setup as JTS
from rust_eth_kzg_tpu_torch import TrustedSetup
from rust_eth_kzg_tpu_torch.models import naive
from rust_eth_kzg_tpu_torch.utils import bls_host as B
from rust_eth_kzg_tpu_torch.utils import trusted_setup as TS

# One intra-op thread, as every CPU test module of the port.
torch.set_num_threads(1)

CACHE_NAME = re.compile(r"setup_cache_[0-9a-f]{16}\.npz")


@pytest.fixture(scope="module")
def mainnet_json():
    with open(TS.SETUP_JSON_PATH) as fh:
        return fh.read()


@pytest.fixture(scope="module")
def mainnet(mainnet_json):
    return TrustedSetup.from_json_unchecked(mainnet_json)


@pytest.fixture(scope="module")
def small_json():
    g1s, g2s, _ = naive.insecure_setup(8, 3)
    return json.dumps({
        "g1_monomial": ["0x" + B.g1_compress(p).hex() for p in g1s],
        "g2_monomial": ["0x" + B.g2_compress(p).hex() for p in g2s],
    })


@pytest.fixture
def cache_dir(tmp_path, monkeypatch):
    monkeypatch.setattr(TS, "CACHE_DIR", str(tmp_path))
    return tmp_path


def _files(d):
    return sorted(os.listdir(d))


def _counting_parse(monkeypatch, result):
    calls = []

    def parse(json_str, subgroup_check):
        calls.append(subgroup_check)
        return result

    monkeypatch.setattr(TS, "_parse", parse)
    return calls


def _no_parse(monkeypatch):
    def parse(json_str, subgroup_check):
        raise AssertionError("parsed where the cache should have been loaded")

    monkeypatch.setattr(TS, "_parse", parse)


def test_default_writes_once_then_loads(cache_dir, mainnet, monkeypatch):
    calls = _counting_parse(monkeypatch, mainnet)
    first = TrustedSetup.default()
    assert calls == [False] and first == mainnet
    names = _files(cache_dir)
    assert len(names) == 1 and CACHE_NAME.fullmatch(names[0])
    _no_parse(monkeypatch)
    second = TrustedSetup.default()
    assert second.g1_monomial == mainnet.g1_monomial and second.g2_monomial == mainnet.g2_monomial
    assert len(second.g1_monomial) == 4096 and len(second.g2_monomial) == 65
    assert _files(cache_dir) == names


def test_points_equal_jax_parse(cache_dir, mainnet, mainnet_json):
    want = JTS.TrustedSetup.from_json_unchecked(mainnet_json)
    assert mainnet.g1_monomial == want.g1_monomial
    assert mainnet.g2_monomial == want.g2_monomial
    path = TS.cache_path(mainnet_json)
    assert TS.save_cache(path, mainnet)
    loaded = TS.load_cache(path)
    assert loaded.g1_monomial == want.g1_monomial and loaded.g2_monomial == want.g2_monomial


def test_other_json_gets_its_own_cache(cache_dir, mainnet, mainnet_json, small_json, tmp_path_factory, monkeypatch):
    TS.save_cache(TS.cache_path(mainnet_json), mainnet)
    other = tmp_path_factory.mktemp("json") / "setup.json"
    other.write_text(small_json)
    monkeypatch.setattr(TS, "SETUP_JSON_PATH", str(other))
    want = TrustedSetup.from_json_unchecked(small_json)
    calls = _counting_parse(monkeypatch, want)
    assert TrustedSetup.default() == want and calls == [False]
    names = _files(cache_dir)
    assert len(names) == 2 and all(CACHE_NAME.fullmatch(n) for n in names)
    assert os.path.basename(TS.cache_path(small_json)) in names
    _no_parse(monkeypatch)
    assert TrustedSetup.default() == want


def test_from_json_unchecked(small_json):
    g1s, g2s, _ = naive.insecure_setup(8, 3)
    unchecked = TrustedSetup.from_json_unchecked(small_json)
    assert unchecked == TrustedSetup.from_json(small_json, subgroup_check=False)
    assert unchecked == TrustedSetup.from_json(small_json) == TrustedSetup(g1s, g2s)


def test_writers_leave_one_whole_cache(cache_dir, small_json):
    setup = TrustedSetup.from_json_unchecked(small_json)
    path = TS.cache_path(small_json)
    assert TS.save_cache(path, setup) and TS.save_cache(path, setup)
    assert _files(cache_dir) == [os.path.basename(path)]
    assert os.stat(path).st_mode & 0o777 == 0o644  # readable by other users
    # a leftover temporary file of another writer (the JAX package's name)
    foreign = path + ".tmp"
    with open(foreign, "wb") as fh:
        fh.write(b"partial")
    assert TS.save_cache(path, setup)
    assert _files(cache_dir) == sorted([os.path.basename(path), os.path.basename(foreign)])
    assert TS.load_cache(path) == setup
    with open(foreign, "rb") as fh:
        assert fh.read() == b"partial"


def test_concurrent_writers_and_a_reader(cache_dir, small_json):
    """Writers racing on one path never show a reader a partial file: it
    sees no cache or the whole one."""
    setup = TrustedSetup.from_json_unchecked(small_json)
    path = TS.cache_path(small_json)
    seen, errors = [], []

    def write():
        try:
            for _ in range(20):
                assert TS.save_cache(path, setup)
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(e)

    writers = [threading.Thread(target=write) for _ in range(4)]
    for t in writers:
        t.start()
    while any(t.is_alive() for t in writers):
        seen.append(TS.load_cache(path))
    for t in writers:
        t.join()
    assert not errors
    assert all(s is None or s == setup for s in seen)
    assert _files(cache_dir) == [os.path.basename(path)] and TS.load_cache(path) == setup


def test_identity_points_round_trip(cache_dir, small_json):
    setup = TrustedSetup.from_json_unchecked(small_json)
    with_inf = TrustedSetup([None] + setup.g1_monomial[1:] + [None], [setup.g2_monomial[0], None])
    path = os.path.join(cache_dir, "setup_cache_0000000000000000.npz")
    assert TS.save_cache(path, with_inf)
    assert TS.load_cache(path) == with_inf
    prover_only = TrustedSetup(setup.g1_monomial)
    assert TS.save_cache(path, prover_only)
    assert TS.load_cache(path) == TrustedSetup(setup.g1_monomial, [])


def test_unreadable_or_other_layout_is_a_miss(cache_dir, small_json, monkeypatch, tmp_path_factory):
    setup = TrustedSetup.from_json_unchecked(small_json)
    other = tmp_path_factory.mktemp("json") / "setup.json"
    other.write_text(small_json)
    monkeypatch.setattr(TS, "SETUP_JSON_PATH", str(other))
    path = TS.cache_path(small_json)
    with open(path, "wb") as fh:
        fh.write(b"not an npz")
    assert TS.load_cache(path) is None
    monkeypatch.setattr(TS, "CACHE_LAYOUT", TS.CACHE_LAYOUT + 1)
    assert TrustedSetup.default() == setup  # parsed, and the cache rewritten
    assert TS.load_cache(path) == setup
    monkeypatch.setattr(TS, "CACHE_LAYOUT", TS.CACHE_LAYOUT - 1)
    assert TS.load_cache(path) is None

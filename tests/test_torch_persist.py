"""The table snapshot (rust_eth_kzg_tpu_torch/utils/persist.py) on the CPU,
at the tests/test_fk20.py geometry.

One context is built cold with `table_cache` (a miss: it builds and saves).
A context started from that snapshot runs no G1-FFT and no table build (both
are stubbed to raise), holds bitwise the same tables, and proves and commits
to the bytes of the host oracle (models/naive.py). A snapshot made for
another SRS, geometry, window or layout version, or a truncated one, is
refused: the prover goes on to its build (the stub's exception). Snapshots
live under pytest's tmp_path.
"""

import os
import random
import shutil
from types import SimpleNamespace

import pytest
import torch

from rust_eth_kzg_tpu_torch import DASContext, TrustedSetup
from rust_eth_kzg_tpu_torch.constants import R_SCALAR
from rust_eth_kzg_tpu_torch.models import naive
from rust_eth_kzg_tpu_torch.models.fk20 import FK20Config, FK20Prover
from rust_eth_kzg_tpu_torch.ops import msm as M
from rust_eth_kzg_tpu_torch.ops import ntt
from rust_eth_kzg_tpu_torch.utils import bls_host as B
from rust_eth_kzg_tpu_torch.utils import persist

# One intra-op thread: the plain versions run many small tensor ops, and
# beside other busy processes (xdist workers, XLA compiles) a thread pool
# stalls each op until all its threads are scheduled.
torch.set_num_threads(1)

CFG = FK20Config(poly_len=64, coset_size=8, expansion=2, fk20_window=4, commit_window=4)


class Rebuilt(Exception):
    """Raised by the stubbed build steps: the prover went on to build."""


def _no_build(monkeypatch):
    def stop(*args, **kwargs):
        raise Rebuilt

    monkeypatch.setattr(ntt.Domain, "fft_g1", stop)
    monkeypatch.setattr(M, "build_fixed_base_msm", stop)


@pytest.fixture(scope="module")
def cold(tmp_path_factory):
    """(setup, snapshot path, the context built cold with table_cache)."""
    g1s, g2s, tau = naive.insecure_setup(CFG.poly_len, CFG.coset_size + 1)
    path = str(tmp_path_factory.mktemp("tables") / "tables.snap")
    ctx = DASContext(device="cpu", trusted_setup=TrustedSetup(g1s, g2s), config=CFG, table_cache=path)
    return (g1s, g2s, tau), path, ctx


def _same_tables(a, b):
    for ta, tb in ((a.tables, b.tables), (a.commit_tables, b.commit_tables)):
        assert (ta.window, ta.instance_ndim, ta.chains, ta.wpc) == (tb.window, tb.instance_ndim, tb.chains, tb.wpc)
        assert all(torch.equal(getattr(ta, k), getattr(tb, k)) for k in ("table_x", "table_y", "base_inf"))


def test_load_runs_no_table_build(cold, monkeypatch):
    (g1s, g2s, tau), path, ctx = cold
    assert os.path.getsize(path) > ctx.prover.tables.nbytes + ctx.prover.commit_tables.nbytes
    _no_build(monkeypatch)
    loaded = DASContext(device="cpu", trusted_setup=TrustedSetup(g1s, g2s), config=CFG, table_cache=path)
    monkeypatch.undo()  # the prove runs the G1-FFT
    _same_tables(loaded.prover, ctx.prover)
    rnd = random.Random(30)
    coeffs = [rnd.randrange(R_SCALAR) for _ in range(CFG.poly_len)]
    dom = ntt.Domain(CFG.poly_len, "cpu")
    evals = naive.ntt_host(coeffs, dom.generator)
    blob = b"".join(evals[int(r)].to_bytes(32, "big") for r in ntt.bitrev_indices(CFG.poly_len))
    assert loaded.blob_to_kzg_commitment(blob) == B.g1_compress(naive.commit_with_tau(coeffs, tau))
    _, proofs = loaded.compute_cells_and_kzg_proofs(blob)
    ext = ntt.Domain(CFG.ext_size, "cpu")
    coset = ntt.Domain(CFG.coset_size, "cpu")
    rev = ntt.bitrev_indices(CFG.num_proofs)
    for k in (0, 5, CFG.num_proofs - 1):
        hk = ext.roots[int(rev[k])]
        want, _ = naive.compute_multi_opening_naive(coeffs, [hk * w % R_SCALAR for w in coset.roots], tau)
        assert proofs[k] == B.g1_compress(want), k


def _variant(kind, cold, tmp_path, monkeypatch):
    """(commit key points, config, snapshot path) that must be refused."""
    (g1s, _, _), path, ctx = cold
    if kind == "another_srs":
        return g1s[:-1] + [B.G1_GEN], CFG, path
    if kind == "another_geometry":
        return g1s, FK20Config(64, 16, 2, 4, 4), path
    if kind == "another_window":
        return g1s, FK20Config(64, 8, 2, 4, 5), path
    if kind == "another_layout_version":
        other = str(tmp_path / "v.snap")
        monkeypatch.setattr(persist, "LAYOUT_VERSION", persist.LAYOUT_VERSION + 1)
        ctx.save_tables(other)
        monkeypatch.undo()
        return g1s, CFG, other
    short = str(tmp_path / "short.snap")
    with open(path, "rb") as src, open(short, "wb") as dst:
        dst.write(src.read(os.path.getsize(path) - 1000))
    return g1s, CFG, short


@pytest.mark.parametrize(
    "kind", ["another_srs", "another_geometry", "another_window", "another_layout_version", "truncated"]
)
def test_mismatched_snapshot_is_refused_and_rebuilt(kind, cold, tmp_path, monkeypatch):
    points, cfg, path = _variant(kind, cold, tmp_path, monkeypatch)
    size = os.path.getsize(path)
    assert persist.try_load_tables(path, persist.srs_fingerprint(points), cfg.fk20_window, cfg.commit_window,
                                   persist.config_geometry(cfg), "cpu") is None
    _no_build(monkeypatch)
    with pytest.raises(Rebuilt):
        FK20Prover(points, cfg, "cpu", table_cache=path)
    assert os.path.getsize(path) == size


def test_table_cache_variable_is_honoured(cold, tmp_path, monkeypatch):
    """KZG_TPU_TABLE_CACHE names the snapshot when table_cache is None; an
    explicit table_cache wins; without either the context builds."""
    (g1s, g2s, _), path, ctx = cold
    setup = TrustedSetup(g1s, g2s)
    _no_build(monkeypatch)
    monkeypatch.setenv("KZG_TPU_TABLE_CACHE", path)
    _same_tables(DASContext(device="cpu", trusted_setup=setup, config=CFG).prover, ctx.prover)
    monkeypatch.setenv("KZG_TPU_TABLE_CACHE", str(tmp_path / "missing.snap"))
    _same_tables(DASContext(device="cpu", trusted_setup=setup, config=CFG, table_cache=path).prover, ctx.prover)
    with pytest.raises(Rebuilt):
        DASContext(device="cpu", trusted_setup=setup, config=CFG)
    monkeypatch.delenv("KZG_TPU_TABLE_CACHE")
    with pytest.raises(Rebuilt):
        DASContext(device="cpu", trusted_setup=setup, config=CFG)


def test_save_and_load_tables(cold, tmp_path, monkeypatch):
    """DASContext.save_tables writes a snapshot (through a temporary file,
    none left behind) that load_tables takes; a snapshot of another
    geometry is refused and leaves the tables as they were."""
    (g1s, _, _), path, ctx = cold
    mine = str(tmp_path / "mine.snap")
    ctx.save_tables(mine)
    assert sorted(os.listdir(tmp_path)) == ["mine.snap"]
    before = SimpleNamespace(tables=ctx.prover.tables, commit_tables=ctx.prover.commit_tables)
    assert ctx.load_tables(mine) is True
    assert ctx.prover.tables is not before.tables
    _same_tables(ctx.prover, before)
    other = str(tmp_path / "other.snap")
    shutil.copy(mine, other)
    with open(other, "r+b") as fh:  # the geometry field of the JSON header, 64 -> 32
        raw = fh.read(4096)
        at = raw.index(b'"geometry": [64')
        fh.seek(at + len(b'"geometry": ['))
        fh.write(b"32")
    current = ctx.prover.tables
    assert ctx.load_tables(other) is False
    assert ctx.prover.tables is current

"""The port's stage spans (rust_eth_kzg_tpu_torch/utils/tracing.py) on the CPU.

`FK20Prover.prove_from_poly` runs the JAX prover's four spans, in its
order; the three PeerDAS calls of `DASContext` run a root span each over
their stages. The context is the smallest FK20 geometry (poly_len 8, cells
of 4, windows of 2, insecure setup): a prove on the CPU's plain versions
takes several seconds, and under torch.profiler it records millions of host
ops (3.4 million, a trace of about 1 GB, at poly_len 16). So the real calls
run with `KZG_TPU_TRACE` on and off, and the profiler trace is taken of a
prove whose stages return a real prove's intermediates at once; on the
card, tests/test_torch_kernels_cuda.py traces a real mainnet prove,
recovery and verify.
"""

import glob
import json
import re

import numpy as np
import pytest
import torch

from rust_eth_kzg_tpu_torch import DASContext
from rust_eth_kzg_tpu_torch.constants import R_SCALAR
from rust_eth_kzg_tpu_torch.errors import InvalidProofError
from rust_eth_kzg_tpu_torch.models import fk20
from rust_eth_kzg_tpu_torch.models import naive
from rust_eth_kzg_tpu_torch.models.fk20 import FK20Config
from rust_eth_kzg_tpu_torch.ops import field as F
from rust_eth_kzg_tpu_torch.ops import ntt
from rust_eth_kzg_tpu_torch.utils import bls_host as B
from rust_eth_kzg_tpu_torch.utils import tracing
from rust_eth_kzg_tpu_torch.utils.trusted_setup import TrustedSetup

# One intra-op thread, as every CPU test module of the port.
torch.set_num_threads(1)

CFG = FK20Config(poly_len=8, coset_size=4, expansion=2, fk20_window=2, commit_window=2)
SPANS = ["fk20/h_poly_commitments", "fk20/proofs_g1_fft", "fk20/coset_evaluations", "fk20/batch_normalize"]
LINE = re.compile(r"\[kzg-tpu\] (\S+): \d+\.\d\d ms")


CALL_SPANS = {
    "prover": SPANS,
    "prove": ["das/blob_codec", *SPANS, "das/cells_bytes", "das/proofs_bytes",
              "das/compute_cells_and_kzg_proofs_batch"],
    "recover": ["das/recovery_arrays", "das/upload", "rs/decode", *SPANS, "das/degree_check", "das/cells_bytes",
                "das/proofs_bytes", "das/recover_cells_and_kzg_proofs_batch"],
    "verify": ["das/verify_inputs", "verifier/prepare", "verifier/decompress", "verifier/lincomb",
               "verifier/interpolate", "verifier/check", "das/verify_cell_kzg_proof_batch"],
}


@pytest.fixture(scope="module")
def setup():
    return naive.insecure_setup(CFG.poly_len, CFG.coset_size + 1)


@pytest.fixture(scope="module")
def ctx(setup):
    return DASContext(device="cpu", trusted_setup=TrustedSetup(*setup[:2]), config=CFG)


@pytest.fixture(scope="module")
def prover(ctx):
    return ctx.prover


def _scalar_bytes(values):
    return b"".join(v.to_bytes(32, "big") for v in values)


@pytest.fixture(scope="module")
def blobs(setup):
    """Two blobs with their cells, proofs and commitments from the host
    oracle (models/naive.py, the setup's known tau)."""
    tau = setup[2]
    ext, coset = ntt.Domain(CFG.ext_size, "cpu"), ntt.Domain(CFG.coset_size, "cpu")
    blob_rev, ext_rev = ntt.bitrev_indices(CFG.poly_len), ntt.bitrev_indices(CFG.ext_size)
    proof_rev, m = ntt.bitrev_indices(CFG.num_proofs), CFG.coset_size
    rng = np.random.default_rng(91)
    out = []
    for _ in range(2):
        coeffs = [int(v) ** 3 % R_SCALAR for v in rng.integers(1, 2**62, size=CFG.poly_len)]
        evals = naive.ntt_host(coeffs, ntt.Domain(CFG.poly_len, "cpu").generator)
        blob = _scalar_bytes([evals[int(i)] for i in blob_rev])
        ext_evals = naive.ntt_host(coeffs + [0] * (CFG.ext_size - CFG.poly_len), ext.generator)
        flat = [ext_evals[int(i)] for i in ext_rev]
        cells = tuple(_scalar_bytes(flat[k * m : (k + 1) * m]) for k in range(CFG.num_proofs))
        proofs = tuple(
            B.g1_compress(naive.compute_multi_opening_naive(
                coeffs, [ext.roots[int(proof_rev[k])] * w % R_SCALAR for w in coset.roots], tau)[0])
            for k in range(CFG.num_proofs)
        )
        out.append((blob, cells, proofs, B.g1_compress(naive.commit_with_tau(coeffs, tau))))
    return out


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(90)
    vals = [int(v) ** 3 % R_SCALAR for v in rng.integers(1, 2**62, size=CFG.poly_len)]
    return torch.from_numpy(F.FR.to_mont_host(vals)).reshape(8, 1, CFG.poly_len)


def _flat(out):
    proofs, cells = out
    return [c.clone() for c in (*proofs, cells)]


def test_device_trace_holds_the_spans_in_order(prover, data, tmp_path, monkeypatch):
    """prove_from_poly under device_trace, its stages stubbed to return a
    real prove's intermediates (each after one small torch op)."""
    poly = prover.blob_to_poly(data)
    h = prover._h_poly_commitments(poly)
    proofs = prover._proofs_from_h(h)
    cells = prover._coset_evaluations(poly)
    normal = fk20.C.batch_normalize(proofs)
    called = []

    def stub(name, value):
        def run(*args):
            called.append(name)
            torch.ones(4).sum()
            return value
        return run

    monkeypatch.setattr(prover, "_h_poly_commitments", stub(SPANS[0], h))
    monkeypatch.setattr(prover, "_proofs_from_h", stub(SPANS[1], proofs))
    monkeypatch.setattr(prover, "_coset_evaluations", stub(SPANS[2], cells))
    monkeypatch.setattr(fk20.C, "batch_normalize", stub(SPANS[3], normal))
    with tracing.device_trace(str(tmp_path)) as prof:
        out = prover.prove_from_poly(poly)
    assert called == SPANS and out[0] is normal and out[1] is cells
    assert {e.key for e in prof.key_averages()} >= set(SPANS)
    traces = glob.glob(str(tmp_path / "*.pt.trace.json"))
    assert len(traces) == 1
    with open(traces[0]) as fh:
        events = json.load(fh)["traceEvents"]
    spans = sorted((e["ts"], e["name"]) for e in events if e.get("name") in SPANS and e.get("ph") == "X")
    assert [name for _, name in spans] == SPANS


def test_span_prints_only_when_enabled(monkeypatch, capsys):
    monkeypatch.setattr(tracing, "TRACE_ENABLED", False)
    with tracing.span("unit/off", device="cpu"):
        torch.ones(2).sum()
    assert capsys.readouterr().out == ""
    monkeypatch.setattr(tracing, "TRACE_ENABLED", True)
    with tracing.span("unit/on"):
        pass
    with pytest.raises(KeyError), tracing.span("unit/raises", device=torch.device("cpu")):
        raise KeyError("inside")
    lines = capsys.readouterr().out.splitlines()
    assert [LINE.fullmatch(line).group(1) for line in lines] == ["unit/on", "unit/raises"]


def test_trace_enabled_reads_the_environment(monkeypatch):
    import importlib

    for value, want in (("1", True), ("0", False), ("", False), ("false", False)):
        monkeypatch.setenv("KZG_TPU_TRACE", value)
        assert importlib.reload(tracing).TRACE_ENABLED is want
    monkeypatch.delenv("KZG_TPU_TRACE")
    assert importlib.reload(tracing).TRACE_ENABLED is False


def _bump(cell: bytes) -> bytes:
    """The cell with its first scalar raised by 1 (mod r)."""
    return ((int.from_bytes(cell[:32], "big") + 1) % R_SCALAR).to_bytes(32, "big") + cell[32:]


def _call(ctx, blobs, case):
    """(the DASContext or FK20Prover method, its arguments) of one case."""
    if case == "prover":
        return ctx.prover.prove_from_data, (ctx._data([b[0] for b in blobs]),)
    if case == "prove":
        return ctx.compute_cells_and_kzg_proofs_batch, ([b[0] for b in blobs],)
    if case == "recover":
        keep = [0, 2]  # half of the cells, every blob missing the same ones
        return ctx.recover_cells_and_kzg_proofs_batch, ([(keep, [b[1][k] for k in keep]) for b in blobs],)
    ks, blob = range(CFG.num_proofs), blobs[0]  # one blob's cells: a verify at this size takes about 10 s
    cells = [blob[1][k] for k in ks]
    if case == "verify-fails":
        cells[1] = _bump(cells[1])
    return ctx.verify_cell_kzg_proof_batch, ([blob[3] for _ in ks], list(ks), cells, [blob[2][k] for k in ks])


@pytest.mark.parametrize("case", ["prover", "prove", "recover", "verify-fails", "verify"])
def test_call_spans_in_exit_order(ctx, blobs, case, monkeypatch, capsys):
    """Each call's stage spans print leaf by leaf, then its root, in exit
    order, with the outputs of the call with tracing off; the prover alone
    prints its four spans and no root; a verify whose pairing fails raises
    from verifier/check and still prints it and the root."""
    fn, args = _call(ctx, blobs, case)
    want = CALL_SPANS[case.split("-")[0]]
    if case == "verify-fails":
        monkeypatch.setattr(tracing, "TRACE_ENABLED", True)
        with pytest.raises(InvalidProofError):
            fn(*args)
        assert [LINE.fullmatch(line).group(1) for line in capsys.readouterr().out.splitlines()] == want
        return
    monkeypatch.setattr(tracing, "TRACE_ENABLED", False)
    off = fn(*args)
    assert capsys.readouterr().out == ""
    monkeypatch.setattr(tracing, "TRACE_ENABLED", True)
    on = fn(*args)
    assert [LINE.fullmatch(line).group(1) for line in capsys.readouterr().out.splitlines()] == want
    if case == "prover":
        on, off = _flat(on), _flat(off)
        assert len(on) == len(off) and all(torch.equal(a, b) for a, b in zip(on, off))
        return
    assert on == off
    if case != "verify":
        assert off == [(b[1], b[2]) for b in blobs]
    else:
        assert off is None

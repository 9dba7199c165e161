"""The port's stage spans (rust_eth_kzg_tpu_torch/utils/tracing.py) on the CPU.

`FK20Prover.prove_from_poly` runs the JAX prover's four spans, in its
order. The prover is the smallest FK20 geometry (poly_len 8, cells of 4,
windows of 2, insecure setup): a prove on the CPU's plain versions takes
several seconds, and under torch.profiler it records millions of host ops
(3.4 million, a trace of about 1 GB, at poly_len 16). So the real proves run with
`KZG_TPU_TRACE` on and off, and the profiler trace is taken of a prove
whose stages return a real prove's intermediates at once; on the card,
tests/test_torch_kernels_cuda.py traces a real mainnet prove.
"""

import glob
import json
import re

import numpy as np
import pytest
import torch

from rust_eth_kzg_tpu_torch.constants import R_SCALAR
from rust_eth_kzg_tpu_torch.models import fk20
from rust_eth_kzg_tpu_torch.models import naive
from rust_eth_kzg_tpu_torch.models.fk20 import FK20Config, FK20Prover
from rust_eth_kzg_tpu_torch.ops import field as F
from rust_eth_kzg_tpu_torch.utils import tracing

# One intra-op thread, as every CPU test module of the port.
torch.set_num_threads(1)

CFG = FK20Config(poly_len=8, coset_size=4, expansion=2, fk20_window=2, commit_window=2)
SPANS = ["fk20/h_poly_commitments", "fk20/proofs_g1_fft", "fk20/coset_evaluations", "fk20/batch_normalize"]
LINE = re.compile(r"\[kzg-tpu\] (\S+): \d+\.\d\d ms")


@pytest.fixture(scope="module")
def prover():
    g1s, _, _ = naive.insecure_setup(CFG.poly_len, 1)
    return FK20Prover(g1s, CFG, torch.device("cpu"))


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(90)
    vals = [int(v) ** 3 % R_SCALAR for v in rng.integers(1, 2**62, size=CFG.poly_len)]
    return torch.from_numpy(F.FR.to_mont_host(vals)).reshape(8, 1, CFG.poly_len)


def _flat(out):
    proofs, cells = out
    return [c.clone() for c in (*proofs, cells)]


def test_prove_with_and_without_trace_lines(prover, data, monkeypatch, capsys):
    monkeypatch.setattr(tracing, "TRACE_ENABLED", False)
    off = _flat(prover.prove_from_data(data))
    assert capsys.readouterr().out == ""
    monkeypatch.setattr(tracing, "TRACE_ENABLED", True)
    on = _flat(prover.prove_from_data(data))
    lines = capsys.readouterr().out.splitlines()
    assert [LINE.fullmatch(line).group(1) for line in lines] == SPANS
    assert len(on) == len(off) and all(torch.equal(a, b) for a, b in zip(on, off))


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

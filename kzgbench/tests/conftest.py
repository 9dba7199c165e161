"""Shared set-up of the benchmark's CPU tests: a checkout root in a temporary
directory that holds a copy of kzgbench/ and a BENCHMARK.json of small cells
(a 64-scalar blob, cells of 8), run with the reference in the program's
place (`reference/standin.py`) and a setup whose tau is known."""

from __future__ import annotations

import json
import os
import shutil
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

TAU = 1234567
SMALL = {"field_elements_per_blob": 64, "field_elements_per_cell": 8, "precomp_width": 4,
         "program": {"builder": "das_context", "kwargs": {}}}
CLOSED = {"mode": "closed"}
SMALL_CELLS = {
    "small.prove": {"pacing": CLOSED, "entry": "prove", "blobs_per_call": 2, "pool_calls": 2, "warmup_calls": 1,
                    "check_calls": 2, "trace_calls": 1},
    "small.recover": {"pacing": CLOSED, "entry": "recover", "blobs_per_call": 2, "pool_calls": 2, "kept_columns": 8,
                      "warmup_calls": 1, "check_calls": 2, "trace_calls": 1},
    "small.verify": {"pacing": CLOSED, "entry": "verify", "blobs_per_call": 2, "pool_calls": 4, "order": "blob-major",
                     "invalid_calls": 2, "warmup_calls": 1, "check_calls": 2, "trace_calls": 1},
}


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; skipped where torch sees none")


def make_root(path, cells=SMALL_CELLS, config=SMALL) -> str:
    """A checkout root at `path`: kzgbench/ copied, and a BENCHMARK.json whose
    metrics are the repository's, over small cells of one small config."""
    root = str(path)
    shutil.copytree(os.path.join(REPO, "kzgbench"), os.path.join(root, "kzgbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(REPO, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    conf = dict(name="small", **config)
    with open(os.path.join(root, "kzgbench", "configs", "small.json"), "w") as fh:
        json.dump(conf, fh)
    bench["configs"] = [{"name": "small", "source": "test", "file": "kzgbench/configs/small.json",
                         "reduced": [], "why": "test"}]
    bench["workloads"] = []
    for name, params in cells.items():
        traffic = name.split(".", 1)[1]
        with open(os.path.join(root, "kzgbench", "workloads", f"{name}.json"), "w") as fh:
            json.dump({"config": "small", "traffic": traffic, "generator": "das", "params": params}, fh)
        bench["workloads"].append({"name": name, "config": "small", "traffic": traffic, "chips": 1, "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        m.pop("workloads", None)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as fh:
        json.dump(bench, fh)
    return root


@pytest.fixture(scope="session")
def small_setup():
    from kzgbench.reference import kzg as REF

    return REF.insecure_setup_g1(SMALL["field_elements_per_blob"], TAU)


@pytest.fixture(scope="session")
def standin():
    from kzgbench.reference import kzg as REF
    from kzgbench.reference.standin import StandIn

    return StandIn(REF.Geometry(SMALL["field_elements_per_blob"], SMALL["field_elements_per_cell"]), TAU)


@pytest.fixture
def card():
    """The card, or a skip: decided here, never at import."""
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; torch sees none")
    return torch

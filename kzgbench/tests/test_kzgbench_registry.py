"""Configurations, cells, traffic generators, metric readers and work counts
are found by name; a new cell loads from new files alone; BENCHMARK.json
keeps to its contract's shape."""

import hashlib
import io
import json
import os
import re

from conftest import REPO, SMALL, SMALL_CELLS, TAU, make_root

from kzgbench import harness, registry

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _tree_digest(path):
    h = hashlib.sha256()
    for d, dirs, files in sorted(os.walk(path)):
        dirs[:] = sorted(x for x in dirs if x != "__pycache__")
        for f in sorted(files):
            with open(os.path.join(d, f), "rb") as fh:
                h.update(f.encode() + fh.read())
    return h.hexdigest()


def test_everything_named_is_found():
    bench = registry.benchmark()
    for w in bench["workloads"]:
        cell = registry.cell(w["name"])
        assert cell["configuration"]["name"] == w["config"]
        assert hasattr(registry.module("traffic", cell["generator"]), "make")
        assert callable(registry.module("programs", cell["configuration"]["program"]["builder"]).build)
        assert callable(registry.module("pacing", cell["params"]["pacing"]["mode"]).drive)
        for trace in (False, True):
            for m in registry.metrics(w["name"], trace):
                assert callable(registry.module("metrics", m["name"]).read)
    for kernel in ("g1_fft", "fixed_base_msm"):
        assert callable(registry.module("work", kernel).work)


def test_new_cell_loads_without_editing_a_file(tmp_path):
    before = _tree_digest(os.path.join(REPO, "kzgbench"))
    root = make_root(tmp_path / "checkout")
    cell = registry.cell("small.verify", root)
    assert cell["params"]["entry"] == "verify" and cell["configuration"]["name"] == "small"
    assert [m["name"] for m in registry.metrics("small.verify", False, root)] == [
        "blobs_per_s", "call_p95_ms", "setup_s"]
    assert _tree_digest(os.path.join(REPO, "kzgbench")) == before


THROWAWAY_PROGRAM = """
from kzgbench.reference import kzg as K
from kzgbench.reference.standin import StandIn


def build(configuration, phase):
    geom = K.Geometry(configuration["field_elements_per_blob"], configuration["field_elements_per_cell"])
    program = StandIn(geom, configuration["program"]["kwargs"]["tau"])
    phase("context_init")
    return program
"""


def test_new_configuration_with_its_own_program_and_an_open_loop_cell(tmp_path, small_setup):
    """A configuration whose program module is its own, and a cell paced as
    an open loop, run from new files and entries alone."""
    before = _tree_digest(os.path.join(REPO, "kzgbench"))
    root = make_root(tmp_path / "checkout")
    bench_path = os.path.join(root, "BENCHMARK.json")
    bench = registry.read_json(bench_path)
    with open(os.path.join(root, "kzgbench", "programs", "throwaway_standin.py"), "w") as fh:
        fh.write(THROWAWAY_PROGRAM)
    conf = dict(SMALL, name="throwaway", program={"builder": "throwaway_standin", "kwargs": {"tau": TAU}})
    with open(os.path.join(root, "kzgbench", "configs", "throwaway.json"), "w") as fh:
        json.dump(conf, fh)
    params = dict(SMALL_CELLS["small.prove"], pacing={"mode": "poisson", "rate_per_s": 40.0})
    with open(os.path.join(root, "kzgbench", "workloads", "throwaway.open.json"), "w") as fh:
        json.dump({"config": "throwaway", "traffic": "open", "generator": "das", "params": params}, fh)
    bench["configs"].append({"name": "throwaway", "source": "test", "file": "kzgbench/configs/throwaway.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "throwaway.open", "config": "throwaway", "traffic": "open", "chips": 1,
                               "why": "test"})
    with open(bench_path, "w") as fh:
        json.dump(bench, fh)
    out, err = io.StringIO(), io.StringIO()
    assert harness.run("throwaway.open", 7, 1.0, False, setup_g1=small_setup, use_card=False, root=root,
                       workers=1, out=out, err=err) == 0
    result = json.loads(out.getvalue().splitlines()[-1])
    assert result["correct"] is True, result["checks"]
    assert 1 <= result["attempted"] <= 40 * 2
    assert {"blobs_per_s", "call_p95_ms", "setup_s"} <= set(result["metrics"])
    assert _tree_digest(os.path.join(REPO, "kzgbench")) == before


def test_benchmark_json_shape():
    bench = registry.benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "kzgbench/run.py"] and bench["paths"] == ["kzgbench"]
    assert 1 <= bench["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in bench[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("kzgbench/") and os.path.exists(os.path.join(REPO, c["file"]))
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and all(0 < m["bound"] <= 0.25 for m in e2e.values())
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert len(w["why"]) <= 200
        reported = [m for m in e2e if w["name"] in e2e[m].get("workloads", [w["name"]])]
        assert "setup_s" in reported and len(reported) >= 2
        assert registry.metrics(w["name"], True)
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        for w in m.get("workloads", []):
            assert w in e2e[m["moves"]].get("workloads", [w])
    assert len(json.dumps(bench)) < 64 * 1024

"""Everything the harness runs is found by name, from files, so that a later
change adds a cell, a configuration, a traffic mix, a metric or a kernel's
work count by adding files and entries, and edits none:

- `BENCHMARK.json` (the checkout's root): the cells, the metrics, their bounds;
- `kzgbench/workloads/<cell>.json`: the cell's configuration, its generator
  and the generator's parameters (the traffic mix, as data);
- `kzgbench/configs/<config>.json`: the deployment, with its `program`:
  the module that builds it and the module's arguments;
- `kzgbench/programs/<builder>.py`: builds the program a configuration runs;
- `kzgbench/traffic/<generator>.py`: a traffic generator;
- `kzgbench/pacing/<mode>.py`: how a cell's calls arrive (its workload
  file's `pacing`: a closed loop, an open one);
- `kzgbench/metrics/<metric>.py`: a metric's reader, `read(run)`;
- `kzgbench/work/<kernel>.py`: a kernel's work, `work(shapes)`.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
import sys

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _checked(name: str) -> str:
    if not _NAME.match(name):
        raise ValueError(f"not a name: {name!r}")
    return name


def read_json(path: str):
    with open(path) as fh:
        return json.load(fh)


def benchmark(root: str = ROOT) -> dict:
    return read_json(os.path.join(root, "BENCHMARK.json"))


def cell(name: str, root: str = ROOT) -> dict:
    """The cell's entry in BENCHMARK.json with its workload file and its
    configuration: {"name", "config", "traffic", "chips", "generator",
    "params", "configuration"}."""
    bench = benchmark(root)
    entries = [w for w in bench["workloads"] if w["name"] == _checked(name)]
    if not entries:
        raise KeyError(f"BENCHMARK.json has no cell {name!r}")
    entry = dict(entries[0])
    spec = read_json(os.path.join(root, "kzgbench", "workloads", f"{name}.json"))
    for key in ("config", "traffic"):
        if spec[key] != entry[key]:
            raise ValueError(f"cell {name}: {key} is {entry[key]!r} in BENCHMARK.json, {spec[key]!r} in its file")
    configs = {c["name"]: c for c in bench["configs"]}
    conf = configs[entry["config"]]
    entry.update(generator=spec["generator"], params=spec["params"],
                 configuration=read_json(os.path.join(root, conf["file"])))
    return entry


def metrics(name: str, trace: bool, root: str = ROOT) -> list[dict]:
    """The metrics a run of cell `name` prints: its end-to-end metrics, or
    with `trace` its per-layer metrics whose moved metric the cell reports."""
    bench = benchmark(root)
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    if not trace:
        return e2e
    reported = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"] if m["moves"] in reported and name in m.get("workloads", [name])]


def module(kind: str, name: str, root: str = ROOT):
    """kzgbench/<kind>/<name>.py, imported from its file."""
    path = os.path.join(root, "kzgbench", kind, f"{_checked(name)}.py")
    key = f"kzgbench_{kind}_{name}".replace(".", "_").replace("-", "_")
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod

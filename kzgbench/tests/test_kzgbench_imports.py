"""No module under kzgbench/ imports JAX or the JAX package, and the
reference imports nothing of the program; top-level names compared whole,
since the port's name begins with the JAX package's."""

import ast
import os
import sys

from conftest import REPO

from kzgbench import harness

BENCH = os.path.join(REPO, "kzgbench")
JAX = {"jax", "jaxlib", "flax", "rust_eth_kzg_tpu"}


def _imports(path):
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def _modules(top):
    for d, _, files in os.walk(top):
        yield from (os.path.join(d, f) for f in files if f.endswith(".py"))


def test_no_module_imports_jax():
    bad = {p: sorted(set(_imports(p)) & JAX) for p in _modules(BENCH)}
    assert not {p: v for p, v in bad.items() if v}


def test_reference_imports_nothing_of_the_program():
    bad = {p: sorted(set(_imports(p)) & (JAX | {"rust_eth_kzg_tpu_torch", "chip_smoke"}))
           for p in _modules(os.path.join(BENCH, "reference"))}
    assert not {p: v for p, v in bad.items() if v}


def test_names_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "rust_eth_kzg_tpu_torch_fake", sys)
    assert not [m for m in harness.loaded_jax() if m.startswith("rust_eth_kzg_tpu_torch")]
    monkeypatch.setitem(sys.modules, "rust_eth_kzg_tpu.api", sys)
    assert "rust_eth_kzg_tpu.api" in harness.loaded_jax()

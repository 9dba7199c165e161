"""The harness's run without the look for a card, with the reference in the
program's place: sound, `correct` is true; with each fault a cell can have
(a step that returns its state unchanged, half of the batch left out, an
answer altered where it is produced) and with the control, false. The
exchange between chips does not exist: every cell takes one card."""

import io
import json

import pytest

from conftest import make_root

from kzgbench import faults, harness

CASES = [(cell, fault) for cell in ("small.prove", "small.recover", "small.verify")
         for fault in (None, "stale", "half_batch", "altered", "control")]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("checkout"))


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_turns_correct_false(root, standin, small_setup, cell, fault):
    wrap = None if fault is None else faults.control if fault == "control" else faults.FAULTS[fault]
    out, err = io.StringIO(), io.StringIO()
    # a seed whose verify pool puts one of its bad cells in the half that half_batch skips
    rc = harness.run(cell, 11, 2.0 if cell == "small.verify" else 0.5, False, program=standin,
                     setup_g1=small_setup, wrap=wrap, use_card=False, root=root, workers=1, out=out, err=err)
    assert rc == 0
    result = json.loads(out.getvalue().splitlines()[-1])
    assert result["correct"] is (fault is None), result["checks"]
    assert list(result)[-1] == "checks"
    assert {"blobs_per_s", "setup_s"} <= set(result["metrics"])
    lines = err.getvalue().splitlines()
    assert lines[-len(result["checks"]):] == [f"check {k}: {v['value']} (limit {v['limit']})"
                                              for k, v in result["checks"].items()]

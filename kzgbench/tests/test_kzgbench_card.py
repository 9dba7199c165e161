"""On the card, at the cells' own sizes and loads: on each of three seeds the
program as it is comes out correct and the control (kzgbench/faults.py) does
not. One program a cell serves every run, as the runs would build it alike.
Each reading is printed as a JSON line (`-s` shows them):

    python -m pytest -m cuda -s kzgbench/tests/test_kzgbench_card.py
"""

import io
import json

import pytest

from kzgbench import faults, harness, registry

SEEDS = (2**31 + 4242, 2**31 + 4243, 2**31 + 4244)
# long enough for every cell to call each entry of its pool at least once
SECONDS = 6.0


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in registry.benchmark()["workloads"]])
def test_control_fails_where_the_program_passes(card, cell):
    conf = registry.cell(cell)["configuration"]
    program = registry.module("programs", conf["program"]["builder"]).build(conf, lambda _: None)
    for seed in SEEDS:
        for mode, wrap, want in (("sound", None, True), ("control", faults.control, False)):
            out, err = io.StringIO(), io.StringIO()
            assert harness.run(cell, seed, SECONDS, False, program=program, wrap=wrap, out=out, err=err) == 0
            result = json.loads(out.getvalue().splitlines()[-1])
            print(json.dumps({"cell": cell, "mode": mode, "seed": seed, "attempted": result["attempted"],
                              "metrics": result["metrics"], "checks": result["checks"]}), flush=True)
            assert result["correct"] is want, (mode, seed, result["checks"])
